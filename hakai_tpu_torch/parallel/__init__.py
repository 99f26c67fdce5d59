"""Multi-device runs of the port over ``torch.distributed``: one process
per rank (:mod:`.dist`), elements sharded over the ranks and node state
replicated (:mod:`.sharding`, the counterpart of
``hakai_tpu/parallel/sharding.py``)."""
