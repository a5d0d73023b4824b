"""Paper core: tensors, bounds, MTTKRP references, CP-ALS."""
