"""Data: Darknet boxes and synthetic detection scenes (NumPy)."""
