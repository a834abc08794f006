"""Four-level hierarchical molecular graphs with static shapes.

* ``build``     — host-side molecule → ragged numpy arrays
* ``hiergraph`` — the padded ``HierGraphBatch`` + PadSpec / pad_batch
* ``batch``     — numpy batch → torch tensors on a device
"""
