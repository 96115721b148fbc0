"""Schedule-parameterized flash attention (fwd): the program and its kernel.

:func:`make_program` is the JAX package's instruction stream for one
(query tile, kv block) step (``repro/kernels/flash_attention/kernel.py:38``)
with two faces per instruction: a torch ``fn`` (the CPU face, run by
``Program.execute`` over the grid with the running statistics carried
across kv blocks, as Pallas interpret mode runs the reference off-TPU) and a
CUDA ``src`` snippet that ``Program.emit`` lays out in schedule order inside
the kv loop of ``csrc/flash_attention.cu``: tensor cores (bf16 m16n8k16, or
float32 as 3xTF32 m16n8k8 from the operand path in
``csrc/flash_attention_f32.cu``) and ``cp.async`` loads whose waits follow
the order.  MEM instructions (the q load, per-chunk K and V loads, the
output store) are SIP's movable set.

:class:`FlashKernel` is one schedule of the kernel: on CPU tensors it runs
the CPU face, on CUDA tensors it emits, builds (once per text) and launches
the CUDA kernel, counting ``launches``.  :func:`flash_attention` is the
model's entry point: the plain version on CPU tensors, the registry's shared
instance (``ops.kernel(causal, window)``, which serves the schedule of the
active schedule cache) on CUDA tensors, with lengths padded to a multiple
of :data:`SEQ_TILE`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.energy import UnassemblableSchedule
from repro_torch.core.ir import Instr, Kind, Program
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import _build, count_launch, refuse_grad
from repro_torch.kernels._emit import (AsyncPlanner, buffer_decls, cfloat,
                                       emit_kernel, plan_shared)
from repro_torch.kernels.flash_attention import ref

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
#: the float32 operand path, emitted ahead of :data:`SOURCE`
SOURCE_F32 = "src/repro_torch/csrc/flash_attention_f32.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:179"
FUNCTION = "flash_attention"
CTYPES = {"float32": "float", "bfloat16": "bf16_t"}
NEG_INF = -1e30

launches = 0
#: ``launches`` split by (causal, dtype) of the launched kernel; a windowed
#: kernel is causal
variant_launches = {(c, t): 0 for c in (True, False) for t in CTYPES}
#: the model's calls reach the kernel at lengths padded to a multiple
#: of this (:func:`padded`): the knob space gives a length that is not a
#: multiple of 8 one-row query tiles, and most multiples of 8 eight-row
#: tiles; a multiple of 64 gets tiles of 64 or 128 rows
SEQ_TILE = 64


def make_program(*, bq: int, bk: int, n_chunks: int, d: int, sq: int,
                 skv: int, causal: bool, window: int | None,
                 dtype="float32", batch_heads: int = 1) -> Program:
    if bk % n_chunks:
        raise ValueError(f"n_chunks {n_chunks} must divide bk {bk}")
    ck = bk // n_chunks
    replications = batch_heads * (sq // bq) * (skv // bk)
    dtype = getattr(torch, dtype_name(dtype))
    esize = torch.empty((), dtype=dtype).element_size()
    scale = d ** -0.5
    instrs: list[Instr] = []

    # ---- loads -------------------------------------------------------------
    instrs.append(Instr(
        name="ld_q", kind=Kind.MEM, inputs=(), outputs=("q",),
        fn=lambda env: {"q": env["q_ref"][0].float()},
        buffer="q", bytes=bq * d * esize,
        src="if (first) load_rows<BQ, BQP>(qp, Q, q0, sq); cp_async_commit();"))

    def ld_k(env, c):
        return {f"k{c}": env["k_ref"][0, c * ck:(c + 1) * ck, :].float()}

    def ld_v(env, c):
        return {f"v{c}": env["v_ref"][0, c * ck:(c + 1) * ck, :].float()}

    def qk(env, c):
        return {f"s{c}": (env["q"] @ env[f"k{c}"].T) * scale}

    def mk_mask(env, c):
        i, j = env["i"], env["j"]
        rows = i * bq + torch.arange(bq)[:, None] + (skv - sq)
        cols = j * bk + c * ck + torch.arange(ck)[None, :]
        # keys at or past a padded call's real length are masked
        m = torch.ones((bq, ck), dtype=torch.bool) & (
            cols < env.get("kv_len", skv))
        if causal:
            m &= cols <= rows
        if window is not None:
            m &= cols > rows - window
        return {f"mask{c}": m,
                f"sm{c}": torch.where(m, env[f"s{c}"], NEG_INF)}

    for c in range(n_chunks):
        instrs.append(Instr(name=f"ld_k{c}", kind=Kind.MEM, inputs=(),
                            outputs=(f"k{c}",), fn=functools.partial(ld_k, c=c),
                            buffer="k", bytes=ck * d * esize,
                            src=f"load_rows<CK, CKP>(kp, K{c}, kb + {c * ck}, "
                                f"skv); cp_async_commit();"))
        instrs.append(Instr(name=f"qk{c}", kind=Kind.COMPUTE,
                            inputs=("q", f"k{c}"), outputs=(f"s{c}",),
                            fn=functools.partial(qk, c=c),
                            flops=2 * bq * ck * d,
                            src=f"qk_tile(Q, K{c}, S[{c}]);"))
        instrs.append(Instr(name=f"mask{c}", kind=Kind.COMPUTE,
                            inputs=(f"s{c}",), outputs=(f"sm{c}", f"mask{c}"),
                            fn=functools.partial(mk_mask, c=c),
                            flops=bq * ck,
                            src=f"mask_tile(S[{c}], kb + {c * ck}, q0, off, "
                                f"sq, kv_len);"))

    # ---- read running stats (carried across kv blocks) -----------------------
    def ld_stats(env):
        if env["j"] == 0:
            return {"m_prev": torch.full((bq, 1), NEG_INF),
                    "l_prev": torch.zeros((bq, 1)),
                    "acc_prev": torch.zeros((bq, d))}
        return {"m_prev": env["m_ref"].clone(), "l_prev": env["l_ref"].clone(),
                "acc_prev": env["acc_ref"].clone()}

    instrs.append(Instr(name="ld_stats", kind=Kind.COMPUTE, inputs=(),
                        outputs=("m_prev", "l_prev", "acc_prev"),
                        fn=ld_stats, buffer="stats", flops=0))

    # ---- online softmax ------------------------------------------------------
    def softmax_update(env):
        m_cur = env["m_prev"]
        for c in range(n_chunks):
            m_cur = torch.maximum(m_cur, env[f"sm{c}"].amax(dim=1, keepdim=True))
        corr = torch.exp(env["m_prev"] - m_cur)
        l_new = corr * env["l_prev"]
        out = {"m_new": m_cur, "corr": corr}
        for c in range(n_chunks):
            p = torch.exp(env[f"sm{c}"] - m_cur) * env[f"mask{c}"]
            out[f"p{c}"] = p
            l_new = l_new + p.sum(dim=1, keepdim=True)
        out["l_new"] = l_new
        return out

    instrs.append(Instr(
        name="softmax", kind=Kind.COMPUTE,
        inputs=("m_prev", "l_prev") + tuple(f"sm{c}" for c in range(n_chunks))
               + tuple(f"mask{c}" for c in range(n_chunks)),
        outputs=("m_new", "l_new", "corr") + tuple(f"p{c}" for c in range(n_chunks)),
        fn=softmax_update, flops=6 * bq * bk,
        src="softmax_rows(S, m_r, l_r, acc, kb, q0, off, sq, kv_len);"))

    # ---- PV and accumulator ---------------------------------------------------
    def pv(env, c):
        return {f"pv{c}": env[f"p{c}"] @ env[f"v{c}"]}

    for c in range(n_chunks):
        instrs.append(Instr(name=f"ld_v{c}", kind=Kind.MEM, inputs=(),
                            outputs=(f"v{c}",), fn=functools.partial(ld_v, c=c),
                            buffer="v", bytes=ck * d * esize,
                            src=f"load_rows<CK, CKP>(vp, V{c}, kb + {c * ck}, "
                                f"skv); cp_async_commit();"))
        instrs.append(Instr(name=f"pv{c}", kind=Kind.COMPUTE,
                            inputs=(f"p{c}", f"v{c}"), outputs=(f"pv{c}",),
                            fn=functools.partial(pv, c=c),
                            flops=2 * bq * ck * d,
                            src=f"pv_tile(S[{c}], V{c}, acc);"))

    def accumulate(env):
        acc = env["corr"] * env["acc_prev"]
        for c in range(n_chunks):
            acc = acc + env[f"pv{c}"]
        return {"acc_new": acc}

    instrs.append(Instr(
        name="accum", kind=Kind.COMPUTE,
        inputs=("corr", "acc_prev") + tuple(f"pv{c}" for c in range(n_chunks)),
        outputs=("acc_new",), fn=accumulate, flops=2 * bq * d * n_chunks))

    # ---- write-back -----------------------------------------------------------
    def st_stats(env):
        env["m_ref"][...] = env["m_new"]
        env["l_ref"][...] = env["l_new"]
        env["acc_ref"][...] = env["acc_new"]
        return {}

    instrs.append(Instr(name="st_stats", kind=Kind.COMPUTE,
                        inputs=("m_new", "l_new", "acc_new"), outputs=(),
                        fn=st_stats, buffer="stats", is_store=True, flops=0))

    def st_o(env):
        if env["j"] == env["nkv"] - 1:
            l_safe = env["l_new"].clamp_min(1e-30)
            env["o_ref"][0] = (env["acc_new"] / l_safe).to(dtype)
        return {}

    instrs.append(Instr(name="st_o", kind=Kind.MEM,
                        inputs=("acc_new", "l_new"), outputs=(),
                        fn=st_o, buffer="o", is_store=True,
                        bytes=bq * d * esize,
                        src="if (last) store_o(op, acc, l_r, q0, sq);"))
    return Program(instrs, replications=replications)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtype: str, d: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}; all must be on one CUDA device")
        if dtype_name(t.dtype) != dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; this "
                             f"schedule takes {dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-D tensor, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    b, hq, _, qd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != qd or qd != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not agree "
                         f"with each other or head_dim {d}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {k.shape[1]} kv heads")


class FlashKernel:
    """One schedule (tiles and order) of flash attention, both faces."""

    def __init__(self, *, bq: int, bk: int, n_chunks: int, d: int, sq: int,
                 skv: int, causal: bool, window: int | None, dtype="float32",
                 batch_heads: int = 1, order: Sequence[int] | None = None):
        if window is not None and window < 1:
            raise ValueError(f"flash_attention: window must be >= 1, got "
                             f"{window}")
        self.bq, self.bk, self.n_chunks, self.d = bq, bk, n_chunks, d
        self.causal, self.window = causal, window
        self.dtype = dtype_name(dtype)
        if self.dtype not in CTYPES:
            raise ValueError(f"flash_attention: dtype {self.dtype} is not one of "
                             f"{list(CTYPES)}")
        self.program = make_program(bq=bq, bk=bk, n_chunks=n_chunks, d=d,
                                    sq=sq, skv=skv, causal=causal,
                                    window=window, dtype=self.dtype,
                                    batch_heads=batch_heads)
        self.order = tuple(order) if order is not None \
            else self.program.default_order()
        if not self.program.is_legal(self.order):
            raise ValueError("illegal schedule order")
        self._text: tuple[str, int] | None = None
        self._kernels: dict[int, _build.Kernel] = {}
        #: this schedule's own launches (the module's ``launches`` counts
        #: every schedule's, from every thread)
        self.launches = 0

    @property
    def threads(self) -> int:
        return 2 * -(-self.bq // 16) * 16   # a warp per 16-row strip

    # ------------------------------------------------------------ CUDA face
    def source(self) -> tuple[str, int]:
        """The emitted CUDA text of this schedule and its shared memory in
        bytes; raises ``UnassemblableSchedule`` when that exceeds a block, a
        warp's scores and output do not fit its registers, or head_dim is
        not whole 16-byte copies."""
        if self._text is None:
            self._text = self._source()
        return self._text

    def _source(self) -> tuple[str, int]:
        bq, d, nch = self.bq, self.d, self.n_chunks
        f32 = self.dtype == "float32"
        esize = 4 if f32 else 2
        per_copy = 16 // esize
        if d % per_copy:
            raise UnassemblableSchedule(f"{FUNCTION}: head_dim {d} is not a "
                                        f"multiple of {per_copy} (16-byte "
                                        f"copies of {self.dtype})")
        ck = self.bk // nch
        # rows to whole 16-row strips; D and keys to the product's depth of
        # 32 bytes (m16n8k16 bf16, m16n8k8 tf32)
        depth = 32 // esize
        bqp = -(-bq // 16) * 16
        ckp, dp = (-(-x // depth) * depth for x in (ck, d))
        ld = dp + per_copy            # a 16-byte pad per row: no conflicts
        # a thread keeps two rows of every score chunk and of the output,
        # and (3xTF32) the hi and lo halves of an A fragment
        _build.check_regs(FUNCTION, self.threads,
                          nch * ckp // 2 + dp // 2 + (8 if f32 else 0))
        buffer_of = {"q": "Q"}
        for c in range(nch):
            buffer_of.update({f"k{c}": f"K{c}", f"v{c}": f"V{c}"})
        sizes = {"Q": bqp * ld * esize}
        for c in range(nch):
            sizes.update({f"K{c}": ckp * ld * esize,
                          f"V{c}": ckp * ld * esize})
        plan = plan_shared(self.program, self.order, buffer_of, sizes,
                           pinned=("Q",))
        _build.check_smem(FUNCTION, plan.total)
        body = self.program.emit(self.order,
                                 before=AsyncPlanner(plan, buffer_of))
        defines = {"T": CTYPES[self.dtype], "TF32": int(f32), "BQ": bq,
                   "BK": self.bk, "CK": ck, "NCH": nch, "D": d,
                   "NT": self.threads, "CAUSAL": int(self.causal),
                   "WINDOW": self.window or 0,
                   "SCALE": cfloat(float(torch.tensor(d ** -0.5))),
                   "BQP": bqp, "CKP": ckp, "DP": dp, "LD": ld,
                   "NTK": ckp // 8, "NTD": dp // 8}
        operands = _build.template("flash_attention_f32.cu") if f32 else ""
        text = emit_kernel(
            _build.template("sip_common.cuh") + operands
            + _build.template("flash_attention.cu"), defines,
            buffer_decls(plan, {b: "T" for b in sizes}), body)
        return text, plan.total

    def _launch(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: int) -> torch.Tensor:
        _check(q, k, v, self.dtype, self.d)
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: q, k and v must start on "
                             "16-byte boundaries (the kernel copies 16 bytes "
                             "at a time)")
        dev = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        kern = self._kernels.get(dev)
        if kern is None:
            text, smem = self.source()
            kern = self._kernels[dev] = _build.load(FUNCTION, text, smem, dev)
        out = torch.empty_like(q)
        if out.numel():
            with torch.cuda.device(q.device):
                kern.launch((b * hq, -(-sq // self.bq), 1), self.threads,
                            [ctypes.c_void_p(q.data_ptr()),
                             ctypes.c_void_p(k.data_ptr()),
                             ctypes.c_void_p(v.data_ptr()),
                             ctypes.c_void_p(out.data_ptr()),
                             ctypes.c_int(hq), ctypes.c_int(hkv),
                             ctypes.c_int(sq), ctypes.c_int(skv),
                             ctypes.c_int(kv_len)])
            count_launch(self, (self.causal, self.dtype))
        return out

    # ------------------------------------------------------------- CPU face
    def _execute(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: int) -> torch.Tensor:
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        bq, bk = self.bq, self.bk
        if hq % hkv or sq % bq or skv % bk:
            raise ValueError(f"tiles ({bq}, {bk}) must divide ({sq}, {skv}) "
                             f"and kv heads {hkv} must divide {hq}")
        group = hq // hkv
        qf = q.reshape(b * hq, sq, d)
        kf = k.reshape(b * hkv, skv, d)
        vf = v.reshape(b * hkv, skv, d)
        out = torch.empty((b * hq, sq, d), dtype=q.dtype)
        nkv = skv // bk
        for bh in range(b * hq):
            kvh = (bh // hq) * hkv + (bh % hq) // group
            for i in range(sq // bq):
                scratch = {"m_ref": torch.empty((bq, 1)),
                           "l_ref": torch.empty((bq, 1)),
                           "acc_ref": torch.empty((bq, d))}
                for j in range(nkv):
                    self.program.execute(
                        {"q_ref": qf[bh:bh + 1, i * bq:(i + 1) * bq],
                         "k_ref": kf[kvh:kvh + 1, j * bk:(j + 1) * bk],
                         "v_ref": vf[kvh:kvh + 1, j * bk:(j + 1) * bk],
                         "o_ref": out[bh:bh + 1, i * bq:(i + 1) * bq],
                         "i": i, "j": j, "nkv": nkv, "kv_len": kv_len,
                         **scratch}, self.order)
        return out.reshape(b, hq, sq, d)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: int | None = None) -> torch.Tensor:
        """Attention over the first ``kv_len`` keys (all of them when None):
        keys at or past it are masked, as a padded call needs."""
        kv_len = k.shape[2] if kv_len is None else kv_len
        if not 0 < kv_len <= k.shape[2]:
            raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                             f"(0, {k.shape[2]}]")
        if all(t.device.type == "cpu" for t in (q, k, v)):
            return self._execute(q, k, v, kv_len)
        return self._launch(q, k, v, kv_len)


def padded(kern, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool) -> torch.Tensor:
    """``kern(q, k, v)``, the sequences padded at the end to a multiple of
    :data:`SEQ_TILE` and the padded query rows dropped.  Both lengths grow
    by the same amount, so every real query row keeps its position.  A
    causal call's padded keys lie after every real row's diagonal and stay
    masked; a bidirectional call passes its real key length, at or past
    which the kernel masks keys."""
    pad = -q.shape[2] % SEQ_TILE
    if not pad or not all(t.is_contiguous() for t in (q, k, v)):
        return kern(q, k, v)     # as given: the kernel rejects a strided view
    q2, k2, v2 = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                  for t in (q, k, v))
    kw = {} if causal else {"kv_len": k.shape[2]}
    return kern(q2, k2, v2, **kw)[:, :, :q.shape[2]]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    CPU tensors take the plain version; otherwise the registry's shared
    kernel for (causal, window) serves the active cache's schedule, on
    :func:`padded` lengths.  A call that autograd would record raises
    (:func:`kernels.refuse_grad`): the kernel has no backward."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention(q, k, v, causal=causal, window=window)
    refuse_grad("flash_attention", q, k, v)
    from repro_torch.kernels.flash_attention import ops
    return padded(ops.kernel(causal, window), q, k, v, causal=causal)
