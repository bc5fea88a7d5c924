"""Scale-out over ``torch.distributed``: landmark-sharded BA and the
event-sharded splat, one process per shard."""
