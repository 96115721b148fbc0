"""Move the JAX package's weights into the port.

``params_from_numpy`` takes ``repro``'s params as numpy arrays —
``jax.tree.map(np.asarray, nn.unwrap(M.init_lm(key, cfg)))``, layers stacked
on axis 0 (a hybrid's groups on two, see ``model.param_shapes``) — and
returns the port's param tree, so both packages compute the same function.
A moe layer's ``ffn`` subtree is the reference's ``init_moe`` tree; an
encoder-decoder's is ``model.param_shapes``'s enc_dec tree, and a padded
config's ``wq``/``wo`` hold all ``padded_heads`` heads.  Norm
gains, the SSM leaves the reference reads in float32 and an MoE router
(whose product the reference runs in float32) stay float32.
``params_to_numpy`` is the inverse: the two trees are path for path the
same, so it is a walk that moves each leaf to a float32 numpy array.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, check_supported


def params_from_numpy(tree: dict[str, Any], cfg: ModelConfig, *,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> M.Params:
    """numpy param tree -> torch param tree on ``device``.  Weights are
    stored in ``dtype`` (default: the compute dtype, which is what the JAX
    package casts them to at every use); ``M.F32_LEAVES`` stay float32.  Raises
    if the tree's names or shapes differ from ``cfg``'s."""
    check_supported(cfg)
    dev = M.resolve_device(device)
    dt = dtype or M.compute_dtype(cfg)

    def convert(path, shape):
        node = tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"params_from_numpy: missing leaf "
                               f"{'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != tuple(shape):
            raise ValueError(f"params_from_numpy: {'/'.join(path)} has shape "
                             f"{arr.shape}, {cfg.name} needs {tuple(shape)}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32
                    if path[-1] in M.F32_LEAVES else dt)

    return M.map_params(convert, M.param_shapes(cfg))


def params_to_numpy(params: M.Params) -> dict[str, Any]:
    """torch param tree -> the reference's tree of float32 numpy arrays,
    at the same paths (what ``params_from_numpy`` takes)."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().to(device="cpu", dtype=torch.float32).numpy()
            for k, v in params.items()}
