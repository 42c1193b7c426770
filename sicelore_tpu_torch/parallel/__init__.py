"""Multi-GPU and multi-process modes (port of `sicelore_tpu/parallel/`).

  shard           a mesh as a list of devices: resolving it, cutting rows
                  into one span a shard, running each shard's work.
  multihost       several processes over one run's fastq files, joined by
                  torch.distributed (gloo): file shards, count all-reduce,
                  stats merge.
"""
