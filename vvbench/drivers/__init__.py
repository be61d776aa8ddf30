"""The general generators: each reads a traffic mix's parameters and drives
the program's entry point for one cell (set-up, the measured window, the
traced window and the check against the plain reference)."""
