"""Datasets: featurization, MoleculeNet tables, splitters, batching, a
synthetic molecule generator, and the ingest of real tables — GDSC, UniMol
LMDB files and the dataset-creation CLI (host code copied from
fragnet_tpu.data, pandas tables as column dicts)."""
