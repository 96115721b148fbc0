"""Deterministic synthetic data pipeline, stateless-resumable (the port of
``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step): a restart needs no pipeline
state beyond the step counter.  Token streams follow a Zipfian unigram
mixture with document structure (BOS-delimited segments).  Both packages
draw with numpy from ``SeedSequence([seed, step, host])``, so the port's
batches equal the reference's bit for bit; only the last move onto the
device differs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    mean_doc_len: int = 256
    zipf_a: float = 1.2


def _rng_for(cfg: DataConfig, step: int, host: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def batch_at(cfg: DataConfig, step: int, *, host: int = 0,
             n_hosts: int = 1) -> dict[str, np.ndarray]:
    """The (host-sliced) batch for ``step`` as numpy arrays.  tokens/labels:
    (B_host, S) int32; mask (B_host, S) float32."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} does not split "
                         f"over {n_hosts} hosts")
    b = cfg.global_batch // n_hosts
    rng = _rng_for(cfg, step, host)
    # zipf unigrams, clipped into vocab; 0 reserved for BOS
    toks = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1)) % (cfg.vocab - 1) + 1
    # document boundaries
    bos = rng.random((b, cfg.seq_len + 1)) < (1.0 / cfg.mean_doc_len)
    toks = np.where(bos, 0, toks).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": np.ones((b, cfg.seq_len), np.float32)}


def batch_for_model(mcfg: ModelConfig, dcfg: DataConfig, step: int,
                    dtype: torch.dtype | None = None, *,
                    device: str | torch.device = "cuda"
                    ) -> dict[str, torch.Tensor]:
    """Model-aware batch on ``device``: an enc_dec model gets stub frontend
    ``enc_embeds`` (B, enc_len, d) beside its tokens, an embeddings-mode
    model stub ``embeds`` (B, S, d) instead of tokens, both standard-normal
    from the host-10,000 stream and cast to ``dtype`` (default: the
    config's compute dtype) through float32, as the reference casts them."""
    raw = batch_at(dcfg, step)
    dt = dtype or getattr(torch, mcfg.dtype)
    rng = _rng_for(dcfg, step, host=10_000)

    def put(a: np.ndarray, to: torch.dtype | None = None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=to)

    out = {"labels": put(raw["labels"]), "mask": put(raw["mask"])}
    if mcfg.family == "enc_dec":
        out["tokens"] = put(raw["tokens"])
        out["enc_embeds"] = put(rng.standard_normal(
            (dcfg.global_batch, mcfg.enc_len, mcfg.d_model))
            .astype(np.float32), dt)
    elif mcfg.input_mode == "embeddings":
        out["embeds"] = put(rng.standard_normal(
            (dcfg.global_batch, dcfg.seq_len, mcfg.d_model))
            .astype(np.float32), dt)
    else:
        out["tokens"] = put(raw["tokens"])
    return out


class DataIterator:
    """Stateless-resumable iterator facade."""

    def __init__(self, mcfg: ModelConfig, dcfg: DataConfig,
                 start_step: int = 0, *, device: str | torch.device = "cuda"):
        self.mcfg, self.dcfg, self.device = mcfg, dcfg, device
        self.step = start_step

    def __next__(self):
        b = batch_for_model(self.mcfg, self.dcfg, self.step,
                            device=self.device)
        self.step += 1
        return b

    def __iter__(self):
        return self
