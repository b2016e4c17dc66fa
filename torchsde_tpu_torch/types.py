"""Type aliases of the port's public signatures (``sdeint``)."""

from typing import Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor
Scalar = Union[float, int, torch.Tensor]
Vector = Union[Sequence[float], np.ndarray, torch.Tensor]

__all__ = ["Scalar", "Tensor", "Vector"]
