"""The epoch-boundary CLOCK walk of the dynamic feature cache."""
