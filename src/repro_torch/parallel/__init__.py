"""Serving steps over the port's LM (no meshes and no shardings on one
card)."""
