"""Distributed training on torch.distributed (counterpart of
fragnet_tpu/dist): data parallelism with gradient averaging
(data_parallel.py) and the edge-partitioned mode with the K3 kernels
(edge_partition.py); rank processes are started by launch.py or torchrun."""
