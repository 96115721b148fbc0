"""The port's CheckpointManager: async saves that in-place updates cannot
reach, integrity verification with corrupt-fallback, GC that never strands
the directory without a restorable checkpoint (the cases of
tests/test_checkpoint.py), and checkpoints that either package restores
from the other with equal arrays and keys."""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten  # noqa: E402
from repro_torch.ft.chaos import corrupt_checkpoint_dir  # noqa: E402


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.normal(size=(16, 8)).astype(np.float32)),
                       "b": torch.from_numpy(
                           rng.normal(size=(8,)).astype(np.float32))},
            "opt": {"mu": torch.zeros((16, 8)),
                    "count": torch.tensor(seed, dtype=torch.int32)}}


def _assert_tree_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


class TestAsyncSave:
    def test_async_save_restores_identically_to_blocking(self, tmp_path):
        t = _tree(1)
        ba = CheckpointManager(str(tmp_path / "a"))
        ba.save(5, t, blocking=True)
        bb = CheckpointManager(str(tmp_path / "b"))
        bb.save(5, t, blocking=False)
        bb.wait()
        sa, ra = ba.restore_latest(_tree())
        sb, rb = bb.restore_latest(_tree())
        assert sa == sb == 5
        _assert_tree_equal(ra, rb)

    def test_async_save_survives_in_place_updates(self, tmp_path):
        """The optimizer updates params and moments in place right after
        save() returns; the snapshot must own its copies, so those updates
        must not reach the write."""
        mgr = CheckpointManager(str(tmp_path))
        t = _tree(2)
        expect = {k: v.clone() for k, v in flatten(t).items()}
        mgr.save(3, t, blocking=False)
        for leaf in flatten(t).values():
            leaf.add_(1).mul_(-7)          # the next optimizer step
        mgr.wait()
        assert mgr.verify(3)
        _, restored = mgr.restore_latest(_tree())
        for k, v in flatten(restored).items():
            assert torch.equal(v, expect[k]), k

    def test_save_returns_caller_blocked_seconds(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        blocked = mgr.save(1, _tree(), blocking=False)
        assert blocked >= 0.0
        mgr.wait()
        assert mgr.verify(1)

    def test_back_to_back_async_saves_serialize(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=10)
        for s in range(1, 5):
            mgr.save(s, _tree(s), blocking=False)
        mgr.wait()
        assert mgr.all_steps() == [1, 2, 3, 4]
        assert all(mgr.verify(s) for s in range(1, 5))


class TestRestoreFallback:
    @pytest.mark.parametrize("mode", ["truncate", "bitflip", "manifest"])
    def test_corrupt_newest_falls_back_to_previous(self, tmp_path, mode):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, _tree(1))
        mgr.save(2, _tree(2))
        corrupt_checkpoint_dir(str(tmp_path / "step_00000002"), mode)
        assert not mgr.verify(2)
        seen = []
        step, restored = mgr.restore_latest(_tree(), on_corrupt=seen.append)
        assert step == 1 and seen == [2]
        _assert_tree_equal(restored, _tree(1))

    def test_all_corrupt_returns_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, _tree(1))
        corrupt_checkpoint_dir(str(tmp_path / "step_00000001"), "truncate")
        seen = []
        step, restored = mgr.restore_latest(_tree(), on_corrupt=seen.append)
        assert (step, restored) == (None, None) and seen == [1]

    def test_latest_pointing_at_deleted_dir_falls_back(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, _tree(1))
        mgr.save(2, _tree(2))
        shutil.rmtree(tmp_path / "step_00000002")   # LATEST now dangles
        assert mgr.latest_step() == 1
        step, restored = mgr.restore_latest(_tree())
        assert step == 1
        _assert_tree_equal(restored, _tree(1))

    def test_stray_files_do_not_break_step_listing(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, _tree())
        (tmp_path / "step_junk").mkdir()            # racing writer debris
        (tmp_path / "step_00000002.tmp").mkdir()
        assert mgr.all_steps() == [1]
        assert mgr.latest_step() == 1

    def test_restore_latest_reads_and_hashes_each_array_once(
            self, tmp_path, monkeypatch):
        """A corrupt newest step and the fallback: each step's arrays are
        read from the file and hashed once (a restore used to verify,
        verify again, then load)."""
        from repro_torch.checkpoint import ckpt as tckpt
        mgr = CheckpointManager(str(tmp_path), keep=5)
        mgr.save(1, _tree(1))
        mgr.save(2, _tree(2))
        corrupt_checkpoint_dir(str(tmp_path / "step_00000002"), "bitflip")
        hashed, loads = [], []
        sha, load = tckpt._sha, np.load
        monkeypatch.setattr(tckpt, "_sha",
                            lambda a: hashed.append(a.nbytes) or sha(a))
        monkeypatch.setattr(tckpt.np, "load",
                            lambda *a, **k: loads.append(a[0]) or
                            load(*a, **k))
        seen = []
        step, restored = mgr.restore_latest(_tree(), on_corrupt=seen.append)
        assert step == 1 and seen == [2]
        _assert_tree_equal(restored, _tree(1))
        n = len(flatten(_tree()))
        assert len(loads) == 2                  # one open a step
        assert len(hashed) <= 2 * n             # the damaged read may stop
        hashed.clear()
        _assert_tree_equal(mgr.restore(1, _tree()), _tree(1))
        assert len(loads) == 3 and len(hashed) == n

    def test_restore_missing_leaf_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"a": torch.zeros(3)})
        with pytest.raises(KeyError, match="missing leaf"):
            mgr.restore(1, {"a": torch.zeros(3), "b": torch.zeros(3)})


class TestGC:
    def test_gc_prunes_old_steps(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(s))
        assert mgr.all_steps() == [3, 4]

    def test_gc_never_deletes_the_only_verified_checkpoint(self, tmp_path):
        """If every kept (newest) step is corrupt, GC must retain the newest
        verified older step — never leave the directory unrestorable."""
        mgr = CheckpointManager(str(tmp_path), keep=1)
        mgr.save(1, _tree(1))
        mgr.save(2, _tree(2))              # gc pass 1: keeps {1 verified, 2}
        assert mgr.all_steps() == [2]
        mgr.keep = 2
        mgr.save(3, _tree(3))
        corrupt_checkpoint_dir(str(tmp_path / "step_00000003"), "truncate")
        mgr.keep = 1
        mgr._gc()                          # doomed=[2], kept=[3] unverifiable
        assert 2 in mgr.all_steps()        # the only verified step survived
        step, _ = mgr.restore_latest(_tree())
        assert step == 2

    def test_gc_normal_path_unaffected_by_verified_keeps(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3):
            mgr.save(s, _tree(s))
        assert mgr.all_steps() == [2, 3]   # newest kept verifies; 1 pruned


class TestCrossPackage:
    """Both packages key arrays by their '/'-joined tree path and hash the
    same bytes, so a checkpoint moves between them either way."""

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        t = _tree(4)
        jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
        jckpt.CheckpointManager(str(tmp_path)).save(7, jt)
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.verify(7)
        step, restored = mgr.restore_latest(_tree())
        assert step == 7
        _assert_tree_equal(restored, t)
        with np.load(tmp_path / "step_00000007" / "arrays.npz") as z:
            assert set(z.files) == set(flatten(t))

    def test_port_checkpoint_restores_in_the_reference(self, tmp_path):
        t = _tree(5)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(9, t, blocking=False)
        mgr.wait()
        jmgr = jckpt.CheckpointManager(str(tmp_path))
        assert jmgr.verify(9)              # the reference's SHA check
        template = jax.tree.map(lambda x: jnp.zeros(x.shape, x.numpy().dtype),
                                _tree())
        step, restored = jmgr.restore_latest(template)
        assert step == 9
        for (path, leaf) in jax.tree_util.tree_flatten_with_path(restored)[0]:
            key = "/".join(p.key for p in path)
            np.testing.assert_array_equal(np.asarray(leaf),
                                          flatten(t)[key].numpy())
