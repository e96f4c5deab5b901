"""Copies of the program's measurement arithmetic, frozen so that a change
to the program cannot move the yardstick.  Each module names its
original."""
