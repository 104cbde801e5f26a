"""Training Zamba2 through the port's entry point ``launch.train.train``, on
one card: the configuration's layers (``layers_block_type[:num_hidden_
layers]``) at the published widths, the port's ``zamba2`` family (its
preset ``configs/zamba2_7b.py`` with the file's depth), batches of
``traffic["batch"]`` x ``traffic["seq"]`` tokens from the program's
``SyntheticLM``, one AdamW update a step, no checkpoint directory.

The loop, the window and the check are ``runners/train.py``'s (its helpers
are imported, not changed): the first ``steps_checked`` steps are set-up
and the ones the reference (``reference/zamba2.py``) follows; the window
is the fewest whole steps whose walls at the last set-up step's fill
``--seconds``.  The check adds the SSD's own gaps: the first ``grouped_ssd``
call's output and input gradients against the reference's SSD on the same
inputs.  Beside the training counters it counts the SSD forward and
backward launches of the window (``ssd_scan``'s launch counts) and their
bound (``counts/zamba2.py``), and the flash-attention FLOPs at the
attention's head dim.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from bench import gen
from bench.counts import zamba2 as work
from bench.harness import Check, Window
from bench.reference import zamba2 as ref
from bench.runners.train import NOUGHT, _WindowDone, _norms, compare, program_optimizer

# ---------------------------------------------------------------------------
# limits (PERF.md, "What decides correct"), each near the geometric mean of
# the largest reading of the program's 17 sound runs and the smallest reading
# above it of the controls (float8 products; the SSD's intra-chunk products
# in bf16) and faults (half the batch; the state unchanged; every hybrid
# layer on memory block 0; the shared block fed x without e), 3 seeds each,
# at the cell's size on the card.  The reasons, number by number (sound max
# / the reading above it):
#   init_gap   exact: the reference draws the same weights from the seed;
#   loss_gap   the bf16 step's rounding of the loss against the f32 one
#              (5.3e-5 / fp8 1.3e-4);
#   grad_gap   the first gradient's worst leaf, bf16 against f32, the SSD's
#              per-head scalars, whose gradients are sums over every token
#              that cancel across the gated norm and keep the bf16
#              activations' rounding: a heavy tail over seeds, 0.014-0.033
#              on 16 runs and 0.059 on one (0.059 / fp8 0.10);
#   mu_gap     the first moment's worst leaf over the checked steps
#              (0.059 / fp8 0.19);
#   nu_gap     the second moment's, which squares the gradient's rounding
#              (0.29 / half batch 0.91, fp8 0.95);
#   change_gap the weights' change over the checked steps, lr 0 then 3e-6
#              (0.015 / half batch 0.086; fp8's 0.026-0.037 sits too close
#              to count, and the shared block without e reads 0.24 here
#              alone);
#   ssd_gap    the timed path's first SSD call (layer 0's mixer, step 0:
#              both groups' launches) against the reference's float32
#              chunked SSD on the same inputs, relative L2 (1.2e-7 / bf16
#              products 2.8e-3): the program's own bf16 activations round
#              the SSD's inputs as much as bf16 products would, so the six
#              numbers above cannot see the SSD's product precision;
#   ssd_bwd_gap the same call's input gradients (dx, ddt, dA, dB, dC, for
#              the output gradient the step gave it) against autograd
#              through the reference's SSD, each rounded to the dtype the
#              program stores it in, the worst relative L2 (8 sound seeds
#              1.1e-4 / 1xTF32 products 1.3e-3, bf16 4.4e-3).
LIMITS = {"init_gap": 0.0, "loss_gap": 8e-5, "grad_gap": 7.8e-2, "mu_gap": 8.5e-2,
          "nu_gap": 0.52, "change_gap": 4e-2, "ssd_gap": 1.8e-5, "ssd_bwd_gap": 3.7e-4}


def port_config(c: Dict[str, Any]):
    """The port's Zamba2Config for the configuration file ``c``: the
    preset at the file's depth, its sizes checked against the file's."""
    from repro_torch.configs.zamba2_7b import CONFIG
    t = c["training"]
    cfg = CONFIG.replace(
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], n_layers=c["num_hidden_layers"],
        head_dim=c["attention_head_dim"], ssm_state=c["mamba_d_state"],
        ssm_expand=c["mamba_expand"], ssm_headdim=c["mamba_headdim"],
        ssm_chunk=c["chunk_size"], ssm_conv=c["mamba_d_conv"],
        ssm_groups=c["mamba_ngroups"], n_mem_blocks=c["num_mem_blocks"],
        adapter_rank=c["adapter_rank"], layer_types=tuple(c["layers_block_type"]),
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        dtype=t["param_dtype"], optimizer_dtype=t["moment_dtype"],
        remat=t["remat"], loss_chunk=t["loss_chunk"])
    if cfg.ssm_heads != c["n_mamba_heads"] or not c["tie_word_embeddings"]:
        raise ValueError("the configuration's n_mamba_heads or untied head is "
                         "not what the zamba2 family runs")
    return cfg


def _named_leaves(params) -> Dict[str, torch.Tensor]:
    """The program's parameter tree by the reference's leaf names (a
    stacked leaf one layer, block or hybrid layer at a time)."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for group in ("mamba", "shared", "hybrid"):
        for k, v in params[group].items():
            for i, t in enumerate(v.unbind(0)):
                out[f"{group}.{i}.{k}"] = t
    return out


def setup(env) -> Dict[str, Any]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.train import train
    from repro_torch.models import zamba2
    o = env.config["training"]["optimizer"]
    differ = {k: (o[k], v) for k, v in program_optimizer().items() if o[k] != v}
    if differ:
        raise ValueError(f"the configuration's optimizer block differs from what "
                         f"the program runs (stated, run): {differ}")
    return dict(cfg=port_config(env.config), fa=fa, ssd=ssd, train=train, zamba2=zamba2)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _first_call(fn, box: List[Dict[str, Any]]):
    """``fn`` (``grouped_ssd``) that keeps its first call on the host: the
    inputs, the output and, once the backward has run, the output's
    gradient ``dy`` and the inputs' gradients through this call alone
    (hooks on views of the inputs, which nothing else reads)."""
    def kept(x, dt, A, B, C, chunk, *args, **kw):
        if box:
            return fn(x, dt, A, B, C, chunk, *args, **kw)
        ins = [t.view_as(t) for t in (x, dt, A, B, C)]
        y = fn(*ins, chunk, *args, **kw)
        call: Dict[str, Any] = dict(inputs=[_host(t) for t in ins], y=_host(y),
                                    chunk=chunk, grads={})
        box.append(call)
        if y.requires_grad:
            y.register_hook(lambda g: call.__setitem__("dy", _host(g)))
            for n, t in zip(ref.SSD_INPUTS, ins):
                if t.requires_grad:
                    t.register_hook(lambda g, n=n: call["grads"].__setitem__(n, _host(g)))
        return y
    return kept


def window(st: Dict[str, Any], env) -> Window:
    c, tr = env.config, env.traffic
    fa, ssd, cfg = st["fa"], st["ssd"], st["cfg"]
    B, S, k_checked = tr["batch"], tr["seq"], tr["steps_checked"]
    b1 = c["training"]["optimizer"]["b1"]
    sync = (lambda: torch.cuda.synchronize(env.device)) \
        if env.device.type == "cuda" else (lambda: None)
    counts = lambda: (fa.launch_count(), fa.bwd_launch_count(),  # noqa: E731
                      ssd.launch_count(), ssd.bwd_launch_count())
    rec: Dict[str, Any] = dict(losses=[], mu=[], nu=[], walls=[], enqueue=[],
                               n_window=None)

    def wrap(step_fn):
        def step(params, opt, batch):
            i = len(rec["walls"])
            if i == 0:
                rec["p0"] = {k: v.detach().to("cpu", copy=True)
                             for k, v in _named_leaves(params).items()}
            if i == k_checked:                    # the window starts
                rec["n_window"] = max(2, math.ceil(env.seconds / rec["walls"][-1]))
                rec["c0"] = counts()
                env.tracer.start()
                rec["t_start"] = time.perf_counter()
            if rec["n_window"] is not None and i == k_checked + rec["n_window"]:
                sync()
                rec["t_end"] = time.perf_counter()
                rec["c1"] = counts()
                env.tracer.stop()
                raise _WindowDone
            z2 = st["zamba2"]
            plain_ssd = z2.grouped_ssd
            if i == 0:      # the first SSD call of the timed path, for the SSD gaps
                z2.grouped_ssd = _first_call(plain_ssd, rec.setdefault("ssd", []))
            t0 = time.perf_counter()
            try:
                out = step_fn(params, opt, batch)
            finally:
                z2.grouped_ssd = plain_ssd
            rec["enqueue"].append(time.perf_counter() - t0)
            loss = float(out[2]["loss"])
            rec["walls"].append(time.perf_counter() - t0)
            if i < k_checked:
                rec["losses"].append(loss)
                rec["mu"].append(_norms(_named_leaves(out[1].mu)))
                rec["nu"].append(_norms(_named_leaves(out[1].nu)))
            if i == 0:        # the first gradient as the optimizer took it
                rec["grad"] = _norms(_named_leaves(out[1].mu), 1.0 / (1.0 - b1))
            if i == k_checked - 1:
                now = _named_leaves(out[0])
                rec["change"] = {k: float(torch.linalg.vector_norm(
                    now[k].float() - rec["p0"][k].to(now[k].device).float()))
                    for k in now}
            return out
        return step

    try:
        st["train"](cfg, steps=c["training"]["optimizer"]["total_steps"],
                    batch=B, seq=S, ckpt_dir=None, seed=gen.seed64(env.seed),
                    log_every=1 << 30, peak_lr=tr["peak_lr"],
                    device=env.device, wrap_step=wrap)
        raise RuntimeError("train() ended before the window did")
    except _WindowDone:
        pass
    n = rec["n_window"]
    st["rec"] = rec
    t_start, t_end = rec["t_start"], rec["t_end"]
    fwd, bwd, sfwd, sbwd = (b - a for a, b in zip(rec["c0"], rec["c1"]))
    env.log(f"train: {k_checked} set-up steps, walls s "
            f"{[round(w, 4) for w in rec['walls']]}; window {n} steps in "
            f"{t_end - t_start:.4f} s; fa launches {fwd} forward, {bwd} backward; "
            f"ssd launches {sfwd} forward, {sbwd} backward; "
            f"losses checked {rec['losses']}")
    return Window(
        t_start=t_start, t_end=t_end, attempted=n, failed=0,
        end_to_end={"train_tokens_per_s": n * B * S / (t_end - t_start)},
        counters={"steps": n, "train_flops": work.train_flops(c, B, S),
                  "enqueue_s": rec["enqueue"][k_checked:k_checked + n],
                  "fa_fwd_launches": fwd, "fa_bwd_launches": bwd,
                  "fa_fwd_flops": fwd * work.fa_fwd_flops(c, B, S),
                  "fa_bwd_flops": bwd * work.fa_bwd_flops(c, B, S),
                  "ssd_fwd_launches": sfwd, "ssd_bwd_launches": sbwd,
                  "ssd_fwd_bound_s": sfwd * work.ssd_fwd_bound_s(c, B, S),
                  "ssd_bwd_bound_s": sbwd * work.ssd_bwd_bound_s(c, B, S)})


def reference(c: Dict[str, Any], traffic: Dict[str, Any], seed: int, device,
              initial=None, **kw) -> Dict[str, Any]:
    """The reference's losses, first gradient norms, moment norms after
    each step and change norms over the checked steps; ``initial(p)``,
    where given, reads its initial weights before the first step; ``kw``
    (``quant``, ``rows``, ``ssd_dtype``, ``fault``) go to
    ``reference.zamba2.loss_and_grads``."""
    o = dict(c["training"]["optimizer"], peak_lr=traffic["peak_lr"])
    B, S, k = traffic["batch"], traffic["seq"], traffic["steps_checked"]
    seed = gen.seed64(seed)
    dtype = getattr(torch, c["training"]["param_dtype"])
    p = ref.init_params(c, seed, device, dtype)
    out: Dict[str, Any] = {"initial": initial(p) if initial else None,
                           "losses": [], "mu": [], "nu": []}
    mu = {n: torch.zeros(t.shape, dtype=torch.float32, device=device) for n, t in p.items()}
    nu = {n: torch.zeros_like(m) for n, m in mu.items()}
    decay = {n: n not in o["undecayed"] for n in p}
    for step in range(k):
        b = gen.lm_batch(seed, step, B, S, c["vocab_size"])
        tok = torch.from_numpy(b["tokens"]).to(device)
        lab = torch.from_numpy(b["labels"]).to(device)
        loss, g = ref.loss_and_grads(p, tok, lab, c, **kw)
        out["losses"].append(loss)
        ref.adamw(p, g, mu, nu, step, o, decay)
        out["mu"].append(_norms(mu))
        out["nu"].append(_norms(nu))
        if step == 0:
            out["grad"] = _norms(mu, 1.0 / (1.0 - o["b1"]))
        del g
    del mu, nu
    p0 = ref.init_params(c, seed, device, dtype)  # drawn again: no copy kept
    out["change"] = {n: float(torch.linalg.vector_norm(p[n].float() - p0[n].float()))
                     for n in p}
    return out


def _worst(got: Dict[str, float], want: Dict[str, float], k: int = 8) -> str:
    """The ``k`` leaves with the largest gaps of norms (``train._gap``'s)."""
    med = float(np.median(list(want.values())))
    gaps = sorted(((abs(got[n] - want[n]) / max(want[n], med, 1e-30), n) for n in want),
                  reverse=True)
    return ", ".join(f"{n} {g:.3e}" for g, n in gaps[:k])


def check(st: Dict[str, Any], win: Window, env) -> List[Check]:
    rec = st.pop("rec")
    p0 = rec.pop("p0")
    st.clear()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = reference(env.config, env.traffic, env.seed, env.device, initial=lambda p: max(
        float((p0[n].to(env.device).float() - w.float()).abs().max()) for n, w in p.items()))
    env.log(f"train check: the reference took {time.perf_counter() - t0:.1f} s")
    got = compare(rec, want)
    call = rec.pop("ssd")[0]
    x, dt, A, B, C = (t.to(env.device) for t in call["inputs"])
    per, chunk = x.shape[2] // B.shape[2], call["chunk"]
    got["ssd_gap"] = ref.ssd_gap(x, dt, A, B, C, chunk, call["y"].to(env.device), per)
    gaps = ref.ssd_bwd_gaps(x, dt, A, B, C, chunk, call["dy"].to(env.device),
                            {n: g.to(env.device) for n, g in call["grads"].items()}, per)
    got["ssd_bwd_gap"] = max(gaps.values())
    env.log("train check: the first SSD call's input gradients against the "
            "reference's, relative L2: " + ", ".join(f"d{n} {g:.3e}" for n, g in gaps.items()))
    med = float(np.median(list(want["grad"].values())))
    still = [n for n, g in want["grad"].items() if g < NOUGHT * med]
    env.log(f"train check: reference losses {want['losses']}, program "
            f"{rec['losses']}; " + ", ".join(f"{k} {v!r}" for k, v in got.items())
            + f"; {len(still)} of {len(want['grad'])} leaves left out of the change {still}")
    env.log("train check: worst leaves: grad " + _worst(rec["grad"], want["grad"])
            + "; nu " + _worst(rec["nu"][-1], want["nu"][-1]))
    return [Check("init_gap", want["initial"], LIMITS["init_gap"])] + [
        Check(k, v, LIMITS[k]) for k, v in got.items()]


def control(env) -> Dict[str, Dict[str, float]]:
    """Readings of the controls (the reference with float8 products, and
    with the SSD's intra-chunk products in bf16, in the program's place)
    and of the planted faults (half the batch; the state unchanged; every
    hybrid layer on memory block 0; the shared block fed x without e),
    against the reference.  The state left unchanged reads the reference's
    own losses (lr is 0 at step 0, so step 1 sees the initial weights) and
    zero moments and change."""
    c, tr = env.config, env.traffic
    want = reference(c, tr, env.seed, env.device)
    zeros = {n: 0.0 for n in want["grad"]}
    out = {"fault_state_unchanged": dict(compare(
        {"losses": want["losses"], "grad": zeros, "mu": [zeros] * len(want["mu"]),
         "nu": [zeros] * len(want["nu"]), "change": zeros}, want),
        ssd_gap=0.0, ssd_bwd_gap=0.0)}
    for name, kw in (("control_fp8", dict(quant="fp8")),
                     ("control_bf16_ssd", dict(ssd_dtype=torch.bfloat16)),
                     ("fault_half_batch", dict(rows=tr["batch"] // 2)),
                     ("fault_block0", dict(fault="block0")),
                     ("fault_no_e", dict(fault="no_e"))):
        t0 = time.perf_counter()
        out[name] = compare(reference(c, tr, env.seed, env.device, **kw), want)
        out[name]["ssd_gap"], out[name]["ssd_bwd_gap"] = _ssd_gaps_of(
            c, tr, env.seed, env.device, kw.get("ssd_dtype", torch.float32))
        env.log(f"control {name}: {out[name]} ({time.perf_counter() - t0:.1f} s)")
    return out


def _ssd_gaps_of(c, tr, seed, device, ssd_dtype) -> Tuple[float, float]:
    """``ssd_gap`` and ``ssd_bwd_gap`` of the reference's own SSD in
    ``ssd_dtype`` products (0 for float32, the reference itself): layer
    0's mixer on the first batch, every sequence, its gradients for an
    output gradient drawn from the seed (dx, dB, dC stored in the
    configuration's dtype, as the program stores them), against float32."""
    if ssd_dtype == torch.float32:
        return 0.0, 0.0
    seed = gen.seed64(seed)
    p = ref.init_params(c, seed, device, getattr(torch, c["training"]["param_dtype"]))
    b = gen.lm_batch(seed, 0, tr["batch"], tr["seq"], c["vocab_size"])
    w = {k: p[f"mamba.0.{k}"].float() for k in ref.MAMBA_KEYS}
    per = c["n_mamba_heads"] // c["mamba_ngroups"]
    rows = []
    with ref._f32_products():
        for row in torch.from_numpy(b["tokens"]).to(device).long():
            u = ref._rms(p["embed"][row].float(), w["norm"], c["rms_norm_eps"])
            x, dt, A, Bh, Ch, _ = ref.ssd_inputs(u, w, c)
            rows.append((x, dt, Bh[:, ::per], Ch[:, ::per]))
    del p
    x, dt, B, C = (torch.stack(t) for t in zip(*rows))
    chunk = c["chunk_size"]
    g = torch.Generator(device=device).manual_seed(seed)
    dy = torch.randn(x.shape, generator=g, device=device)
    num = den = 0.0
    with ref._f32_products():
        for i in range(x.shape[0]):
            Bi, Ci = (t[i].repeat_interleave(per, dim=1) for t in (B, C))
            want = ref.ssd(x[i], dt[i], A, Bi, Ci, chunk)
            got = ref.ssd(x[i], dt[i], A, Bi, Ci, chunk, ssd_dtype)
            num += float(((got - want) ** 2).sum())
            den += float((want ** 2).sum())
    dtype = getattr(torch, c["training"]["param_dtype"])
    grads = {n: t.to(dtype) if n in ("x", "B", "C") else t   # stored as the program's
             for n, t in ref.ssd_grads(x, dt, A, B, C, chunk, dy, per, ssd_dtype).items()}
    return math.sqrt(num / den), max(ref.ssd_bwd_gaps(x, dt, A, B, C, chunk, dy,
                                                      grads, per).values())
