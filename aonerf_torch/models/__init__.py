"""Fields: the vanilla NeRF MLP and the two-level NeRF."""
