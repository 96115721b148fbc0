"""Training launcher of the JAX package (``repro.launch.train``): not ported.

    python -m repro_torch.launch.train      # raises NotImplementedError

The optimizer, data pipeline, train loop, checkpointing and fault tolerance
are ROADMAP.md Queue 1, item 3.
"""

from __future__ import annotations


def main(argv: list[str] | None = None) -> int:
    raise NotImplementedError(
        "repro_torch has no training yet (optimizer, data pipeline, train "
        "loop, checkpointing, fault tolerance): ROADMAP.md Queue 1, item 3")


if __name__ == "__main__":
    raise SystemExit(main())
