"""Training through the port's entry point ``launch.train.train``, on one
card: the configuration's model at its published sizes, batches of
``traffic["batch"]`` x ``traffic["seq"]`` tokens from the program's
``SyntheticLM`` (a pure function of (seed, step)), one AdamW update a
step, no checkpoint directory.

One ``train`` call drives everything through its ``wrap_step`` hook:
the first ``steps_checked`` steps are set-up (the first builds and loads
the kernels) and the ones the reference follows; the window is then a
whole number of steps, the fewest whose walls at the last set-up step's
fill ``--seconds``, timed from the first window step's call to the host's
return after the last one (the loop reads every step's loss, which
synchronises).  After the window the hook stops the loop.

``correct``: the reference (``reference/phi3.py``) starts from the same
seed's weights, drawn by its own copy of the initialiser, and follows the
same ``steps_checked`` steps on the same batches; compared are the initial
weights (exactly), each step's loss, each leaf's first gradient as the
optimizer took it (read from the first moment after step 0: mu = (1 - b1)
g), each leaf's first and second moments after every checked step (the
clipping scale, b1 and b2 act on them), and each leaf's change after the
checked steps, all but the first two by the gap of norms against the
larger of the leaf's and the median leaf's reference norm.

The checked steps fall in the program's warm-up (lr = 0 at step 0), so
the update's size and the weight decay hardly show in the change; the
configuration's optimizer block states what the program is assumed to
run, and ``setup`` refuses a block that differs from the program's own
settings, since ``train`` takes none of them.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from bench import gen
from bench.counts import work
from bench.harness import Check, Window
from bench.reference import phi3 as ref

# compared leaves whose reference first gradient is under this share of
# the median leaf's have no change but round-off, and are left out of the
# change's comparison
NOUGHT = 1e-3


class _WindowDone(Exception):
    """Raised by the step hook to end ``train``'s loop after the window."""


# ---------------------------------------------------------------------------
# limits (PERF.md, "What decides correct"): between the largest reading of
# the program's sound runs over 13 seeds and the smallest of the control's
# (float8 products) and the faults' (half the batch; the state unchanged)
# on 3 seeds each, at the cell's size on the card
LIMITS = {"init_gap": 0.0, "loss_gap": 4.5e-5, "grad_gap": 2.5e-3, "mu_gap": 3e-3,
          "nu_gap": 1e-2, "change_gap": 1e-2}


def port_config(c: Dict[str, Any]):
    """The port's ModelConfig for the configuration file ``c``."""
    from repro_torch.configs import ARCHS
    t = c["training"]
    return ARCHS[c["arch"]].replace(
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], n_layers=c["num_hidden_layers"],
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"],
        sliding_window=c["sliding_window"], dtype=t["param_dtype"],
        optimizer_dtype=t["moment_dtype"], remat=t["remat"],
        loss_chunk=t["loss_chunk"], **c.get("port_overrides", {}))


def _named_leaves(params) -> Dict[str, torch.Tensor]:
    """The program's parameter tree by the reference's leaf names (a
    stacked leaf one layer at a time)."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": params["lm_head"]}
    blocks = params["blocks"]
    flat = {k: v for k, v in blocks.items() if k != "mlp"}
    flat.update(blocks["mlp"])
    for k, v in flat.items():
        for i, t in enumerate(v.unbind(0)):
            out[f"layers.{i}.{k}"] = t
    return out


def _norms(tree: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) * scale for k, v in tree.items()}


def program_optimizer() -> Dict[str, Any]:
    """The optimizer settings the program runs, which ``train`` takes
    none of: ``adamw_update``'s, ``make_train_step``'s warm-up and
    ``cosine_schedule``'s floor, by the configuration's names."""
    import inspect
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_update, cosine_schedule

    def defaults(f):
        return {k: v.default for k, v in inspect.signature(f).parameters.items()
                if v.default is not inspect.Parameter.empty}
    a = defaults(adamw_update)
    return dict({k: a[k] for k in ("b1", "b2", "eps", "weight_decay", "max_grad_norm")},
                warmup_steps=defaults(make_train_step)["warmup"],
                min_ratio=defaults(cosine_schedule)["min_ratio"])


def setup(env) -> Dict[str, Any]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train
    o = env.config["training"]["optimizer"]
    differ = {k: (o[k], v) for k, v in program_optimizer().items() if o[k] != v}
    if differ:
        raise ValueError(f"the configuration's optimizer block differs from what "
                         f"the program runs (stated, run): {differ}")
    cfg = port_config(env.config)
    return dict(cfg=cfg, fa=fa, train=train)


def window(st: Dict[str, Any], env) -> Window:
    c, tr = env.config, env.traffic
    fa, cfg = st["fa"], st["cfg"]
    B, S, k_checked = tr["batch"], tr["seq"], tr["steps_checked"]
    b1 = c["training"]["optimizer"]["b1"]
    sync = (lambda: torch.cuda.synchronize(env.device)) \
        if env.device.type == "cuda" else (lambda: None)
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
                rec["fa0"] = (fa.launch_count(), fa.bwd_launch_count())
                env.tracer.start()
                rec["t_start"] = time.perf_counter()
            if rec["n_window"] is not None and i == k_checked + rec["n_window"]:
                sync()
                rec["t_end"] = time.perf_counter()
                rec["fa1"] = (fa.launch_count(), fa.bwd_launch_count())
                env.tracer.stop()
                raise _WindowDone
            t0 = time.perf_counter()
            out = step_fn(params, opt, batch)
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
    flops = work.train_flops(c, B, S)
    fwd = rec["fa1"][0] - rec["fa0"][0]
    bwd = rec["fa1"][1] - rec["fa0"][1]
    env.log(f"train: {k_checked} set-up steps, walls s "
            f"{[round(w, 4) for w in rec['walls']]}; window {n} steps in "
            f"{t_end - t_start:.4f} s; fa launches {fwd} forward, {bwd} backward; "
            f"losses checked {rec['losses']}")
    return Window(
        t_start=t_start, t_end=t_end, attempted=n, failed=0,
        end_to_end={"train_tokens_per_s": n * B * S / (t_end - t_start)},
        counters={"steps": n, "train_flops": flops,
                  "enqueue_s": rec["enqueue"][k_checked:k_checked + n],
                  "fa_fwd_launches": fwd, "fa_bwd_launches": bwd,
                  "fa_fwd_flops": fwd * work.fa_fwd_flops(c, B, S),
                  "fa_bwd_flops": bwd * work.fa_bwd_flops(c, B, S)})


def reference(c: Dict[str, Any], traffic: Dict[str, Any], seed: int, device,
              quant=None, rows=None, initial=None) -> Dict[str, Any]:
    """The reference's losses, first gradient norms, moment norms after
    each step and change norms over the checked steps; ``initial(p)``,
    where given, reads its initial weights before the first step (and is
    kept as ``"initial"``)."""
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
        loss, g = ref.loss_and_grads(p, tok, lab, c, quant=quant, rows=rows)
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


def _gap(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """Worst leaf's |got - want| / max(want, the median leaf's want)."""
    names = [n for n in want if keep is None or keep(n)]
    med = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)


def compare(prog: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """The compared numbers of a program (or stand-in) reading against
    the reference's."""
    med = float(np.median(list(want["grad"].values())))
    moved = lambda n: want["grad"][n] >= NOUGHT * med  # noqa: E731
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))
    moments = {f"{m}_gap": max(_gap(a, b) for a, b in zip(prog[m], want[m]))
               for m in ("mu", "nu")}
    return {"loss_gap": loss, "grad_gap": _gap(prog["grad"], want["grad"]),
            **moments, "change_gap": _gap(prog["change"], want["change"], moved)}


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
    init = want["initial"]
    got = compare(rec, want)
    med = float(np.median(list(want["grad"].values())))
    still = [n for n, g in want["grad"].items() if g < NOUGHT * med]
    env.log(f"train check: reference losses {want['losses']}, program "
            f"{rec['losses']}; " + ", ".join(f"{k} {v!r}" for k, v in got.items())
            + f"; {len(still)} of {len(want['grad'])} leaves left out of the change {still}")
    return [Check("init_gap", init, LIMITS["init_gap"])] + [
        Check(k, v, LIMITS[k]) for k, v in got.items()]


def control(env) -> Dict[str, Dict[str, float]]:
    """Readings of the control (the reference in float8 products in the
    program's place) and of the half-batch fault, against the reference."""
    want = reference(env.config, env.traffic, env.seed, env.device)
    out = {}
    for name, kw in (("control_fp8", dict(quant="fp8")),
                     ("fault_half_batch", dict(rows=env.traffic["batch"] // 2))):
        got = reference(env.config, env.traffic, env.seed, env.device, **kw)
        out[name] = compare(got, want)
    return out
