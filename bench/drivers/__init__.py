"""Drivers: one a kind of configuration, found by the name its file gives."""
