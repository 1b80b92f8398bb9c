"""Data-parallel sharding of the case axis over a list of devices."""
