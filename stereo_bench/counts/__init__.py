"""Peaks, and the bytes and operations that bound each kernel and each pass."""
