"""Core: dtype names, the seeded generator and the device rule."""
