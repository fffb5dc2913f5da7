"""Frozen yardsticks: the card's published peaks, the kernels' operation
and byte counts, the model FLOP counts and the idle-share arithmetic.
Later changes to the program do not move these."""
