"""Checkpoint interchange and device helpers."""
