"""Model families, one file each (`configs/<config>.json`'s `family`): how
to build the port's generator of a configuration from the run's seed, what
to time inside it, its FLOPs, and the comparison with the family's plain
reference that decides `correct`."""
