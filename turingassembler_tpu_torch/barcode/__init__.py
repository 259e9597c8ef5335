"""Barcode subsystem: read sorting/indexing, per-edge barcode sets,
aux-info mapping."""
