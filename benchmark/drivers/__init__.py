"""Drivers: the program's entry for one family of configurations."""
