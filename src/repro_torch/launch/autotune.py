"""Live autotuning of the JAX package (``repro.launch.autotune``): not ported.

    python -m repro_torch.launch.autotune   # raises NotImplementedError

The autotune service (tune the live traffic mix, gate, promote) and the
engine's schedule hot-swap are ROADMAP.md Queue 1, item 7.  Offline tuning
runs through ``repro_torch.launch.tune``; serving reads its store with
``repro_torch.launch.serve --sip-cache``.
"""

from __future__ import annotations


def main(argv: list[str] | None = None) -> int:
    raise NotImplementedError(
        "repro_torch has no autotune service or schedule hot-swap yet: "
        "ROADMAP.md Queue 1, item 7 (offline: repro_torch.launch.tune, "
        "then launch.serve --sip-cache)")


if __name__ == "__main__":
    raise SystemExit(main())
