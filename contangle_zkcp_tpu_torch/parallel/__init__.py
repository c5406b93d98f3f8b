from .mesh import make_mesh, shard_along, replicated
from .msm_sharded import ShardedMSM
from .ntt_sharded import ShardedNTT
