"""Graph simplification ("resolve") passes — SURVEY.md §2.7."""

from .driver import resolve_graph_operation, resolve_local_graph_operation  # noqa: F401
