"""Sequence and table file formats."""
