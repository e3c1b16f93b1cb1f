"""Beam solver (device kernels' dispatch) and the JAX-free native engine."""
