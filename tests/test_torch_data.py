"""The port's synthetic data pipeline against the JAX package's: both draw
with numpy from ``SeedSequence([seed, step, host])``, so every batch is
bit-equal, tokens, labels, mask and the stub frontend embeddings alike."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


@pytest.mark.parametrize("seed,step,host,n_hosts", [
    (1234, 0, 0, 1), (1234, 7, 0, 1), (9, 3, 1, 2), (0, 100, 3, 4)])
def test_batch_at_is_the_reference_batch(seed, step, host, n_hosts):
    kw = dict(seed=seed, vocab=512, seq_len=48, global_batch=8,
              mean_doc_len=16)
    want = jpipe.batch_at(jpipe.DataConfig(**kw), step, host=host,
                          n_hosts=n_hosts)
    got = tpipe.batch_at(tpipe.DataConfig(**kw), step, host=host,
                         n_hosts=n_hosts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("step", [0, 5])
def test_batch_for_model_is_the_reference_batch(arch, step):
    """Tokens, an embeddings-mode model's ``embeds`` and an enc_dec model's
    ``enc_embeds``, on the float32 smoke configs."""
    kw = dict(seed=3, global_batch=2, seq_len=32)
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    want = jpipe.batch_for_model(jcfg, jpipe.DataConfig(vocab=jcfg.vocab,
                                                        **kw), step)
    got = tpipe.batch_for_model(tcfg, tpipe.DataConfig(vocab=tcfg.vocab,
                                                       **kw), step,
                                device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_iterator_resumes_at_any_step():
    cfg = tconfigs.get_smoke("qwen3-1.7b")
    dcfg = tpipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    it = tpipe.DataIterator(cfg, dcfg, device="cpu")
    first = [next(it) for _ in range(3)]
    again = next(tpipe.DataIterator(cfg, dcfg, start_step=2, device="cpu"))
    assert it.step == 3
    assert torch.equal(again["tokens"], first[2]["tokens"])
