from repro_torch.models.model import build_model
from repro_torch.models.transformer import Model

__all__ = ["build_model", "Model"]
