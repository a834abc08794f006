"""Datasets: featurization, MoleculeNet tables, splitters, batching and a
synthetic molecule generator (host code copied from fragnet_tpu.data)."""
