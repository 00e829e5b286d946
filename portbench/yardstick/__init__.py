"""The yardstick: peaks, bounds and counts of work, frozen with the
benchmark so that a change to the program cannot move them."""
