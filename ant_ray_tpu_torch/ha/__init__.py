"""Head-node high availability (ant-fork capability, ref:
python/ray/ha/ — leader election with lease fencing)."""

from ant_ray_tpu_torch.ha.leader_selector import (
    FileBasedLeaderSelector,
    HeadNodeLeaderSelector,
)

__all__ = ["FileBasedLeaderSelector", "HeadNodeLeaderSelector"]
