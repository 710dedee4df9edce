"""Learning runs of the port (counterparts of the repo's scripts/)."""
