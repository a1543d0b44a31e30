"""Tensor ops: point ops, graph and spectral ops, the selective scan."""
