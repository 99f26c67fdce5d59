"""Multi-device runs of the port over ``torch.distributed``: one process
per rank, spread over the processes of a multi-host run when
:func:`.dist.initialize` has joined one (:mod:`.dist`), elements sharded
over the ranks and node state replicated (:mod:`.sharding`, the
counterpart of ``hakai_tpu/parallel/sharding.py``), or nodes sharded with
halo exchanges (:mod:`.halo`, of ``hakai_tpu/parallel/halo.py``)."""
