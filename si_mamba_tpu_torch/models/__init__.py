"""The PointMamba classifier and its modules."""

from si_mamba_tpu_torch.models.point_mamba import PointMamba, PointMambaConfig

__all__ = ["PointMamba", "PointMambaConfig"]
