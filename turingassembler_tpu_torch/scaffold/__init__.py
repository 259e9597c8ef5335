"""Barcode scaffolding."""
