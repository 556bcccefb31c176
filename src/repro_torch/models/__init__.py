from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model

__all__ = ["ArchConfig", "Model"]
