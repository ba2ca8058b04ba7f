"""The benchmark's own arithmetic: operations and bytes of the MMDiT's
work, and the card's published peaks. Frozen copies, so that a later
change to the program cannot move the yardstick."""
