"""The Zamba2 training cell on the CPU: its runner's counters at a tiny
size, the plain reference against the port's family, the work counts
against a hand count and the SSD bound's independence of the product
precision, the new readers on hand-built traces (silent where launches are
lost), the controls and planted faults judged not correct, the runner's
result line in a fresh process, and the new reference and counts loading
nothing of the program."""
import itertools
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench import control, gen, harness
from bench.counts import zamba2 as work
from bench.reference import zamba2 as ref
from bench.runners import train_zamba2 as runner
from bench.tests import tiny_zamba2
from bench.tests.test_bench_runs import KEYS, _run
from bench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "zamba2-train-4k"
Z7 = json.loads((ROOT / "bench/configs/zamba2-7b.json").read_text())


def _env(seed=2**31 + 9):
    return harness.make_env(CELL, seed, 0.2, False, torch.device("cpu"),
                            overrides=tiny_zamba2.overrides(), log=lambda s: None)


def test_runner_counts_every_counter_of_the_cell():
    """A tiny window on the CPU: every counter the cell's readers take is
    there (the launch counts are the card's, 0 here), and the check passes."""
    env = _env()
    st = runner.setup(env)
    win = runner.window(st, env)
    c = win.counters
    assert set(c) == {"steps", "train_flops", "enqueue_s", "fa_fwd_launches",
                      "fa_bwd_launches", "fa_fwd_flops", "fa_bwd_flops",
                      "ssd_fwd_launches", "ssd_bwd_launches", "ssd_fwd_bound_s",
                      "ssd_bwd_bound_s"}
    assert c["steps"] == win.attempted >= 2 and len(c["enqueue_s"]) == c["steps"]
    assert c["train_flops"] == work.train_flops(env.config, 2, 32)
    checks = runner.check(st, win, env)
    assert harness.verdict(checks), checks


def test_reference_equals_the_ports_float32_step():
    """Initial weights drawn alike from the seed; the loss and every
    leaf's gradient of the port's plain path at the reference's within
    1e-5 of each leaf's largest gradient."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params
    c = {**Z7, **tiny_zamba2.ZAMBA2["config"]}
    cfg = runner.port_config(c).replace(remat=False)
    ours = ref.init_params(c, 78, "cpu", dtype=torch.float32)
    theirs = runner._named_leaves(init_params(cfg, 78, device="cpu"))
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    b = gen.lm_batch(78, 0, 2, 32, c["vocab_size"])
    tok, lab = torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])
    loss, grads = ref.loss_and_grads(ours, tok, lab, c)
    want_loss, _, want = loss_and_grads(init_params(cfg, 78, device="cpu"),
                                        {"tokens": tok, "labels": lab}, cfg)
    want = runner._named_leaves(want)
    assert abs(loss - float(want_loss)) < 1e-5
    for k in grads:
        scale = float(want[k].abs().max())
        assert float((grads[k] - want[k]).abs().max()) <= 1e-5 * scale + 1e-12, k


def test_train_flops_against_a_hand_count_of_the_36_layers():
    """6 x (36 mixers of z, xBC, dt in and out; 6 uses of a shared block's
    q, k, v over 7168, o, gate, up, down, the adapter and the linear; the
    tied head) x tokens, plus 6 attentions of 7 products of 2·224 FLOPs
    per causal pair and head."""
    d, di, ff = 3584, 7168, 14336
    mixer = d * di + d * (di + 2 * 2 * 64) + d * 112 + di * d
    use = 3 * 7168 * 7168 + 7168 * d + 3 * d * ff + 128 * (d + 2 * ff) + d * d
    per_token = 36 * mixer + 6 * use + 32000 * d
    assert mixer == 78_389_248 and per_token == 5_042_372_608
    B, S = 8, 4096
    pairs = S * (S + 1) // 2
    want = 6 * per_token * B * S + 6 * 7 * 2 * 224 * pairs * B * 32
    assert work.train_flops(Z7, B, S) == want


def test_ssd_bound_reads_only_the_configurations_sizes():
    """The bound of a launch is the same whatever precision the
    configuration or the program states for the SSD's products, and the
    forward's at the cell's shape is the memory side's."""
    fwd, bwd = work.ssd_fwd_bound_s(Z7, 8, 4096), work.ssd_bwd_bound_s(Z7, 8, 4096)
    for dtype in ("float32", "bfloat16", "float64"):
        c = dict(Z7, ssm_compute_dtype=dtype,
                 training=dict(Z7["training"], param_dtype=dtype))
        assert (work.ssd_fwd_bound_s(c, 8, 4096), work.ssd_bwd_bound_s(c, 8, 4096)) == \
            (fwd, bwd)
    z = work.ssd_shape(Z7, 8, 4096)
    assert z == dict(b=8, T=4096, H=56, P=64, N=64, l=256)
    assert fwd == work.ssd_fwd_bytes(**z) / work.PEAKS["hbm_bytes_per_s"]
    assert bwd > fwd > 0


def _kernel_trace(names, counters, spans=()):
    kernels = [(n, 10.0 * i, 10.0 * i + 5.0) for i, n in enumerate(names)]
    return Trace(kernels, list(spans), 1.0, counters)


def test_ssd_rooflines_read_the_bound_over_the_kernels_and_go_silent():
    fwd = ["void ssd_cumsum_kernel(float const*)", "ssd_cb_kernel<__nv_bfloat16>",
           "ssd_state_kernel<__nv_bfloat16>", "ssd_pass_kernel", "ssd_scan_kernel<__nv_bfloat16>"]
    bwd = [f"(anonymous namespace)::ssd_bwd_{k}_kernel(Args)" for k in
           ("ds", "ds_sum", "state", "pass", "bc_heads", "bc", "dx", "cumsum")]
    counters = {"ssd_fwd_launches": 2, "ssd_bwd_launches": 1,
                "ssd_fwd_bound_s": 20e-6, "ssd_bwd_bound_s": 10e-6}
    read_f = harness.load_metric("ssd_fwd_roofline.train")
    read_b = harness.load_metric("ssd_bwd_roofline.train")
    tr = _kernel_trace(2 * fwd + bwd + ["fa_wgmma_kernel<224, true>"], counters)
    assert read_f(tr) == pytest.approx(100 * 20e-6 / (10 * 5e-6))
    assert read_b(tr) == pytest.approx(100 * 10e-6 / (8 * 5e-6))
    lost = _kernel_trace(2 * fwd[:-1] + bwd[1:], counters)
    assert read_f(lost) is None and read_b(lost) is None


_IDS = itertools.count(1)


def _ev(name, us, children=(), id=None):
    ev = SimpleNamespace(name=name, cpu_parent=None, cpu_children=list(children),
                         kernels=[SimpleNamespace(name="k", duration=us)],
                         id=next(_IDS) if id is None else id)
    for ch in children:
        ch.cpu_parent = ev
    return ev


def test_mamba_and_shared_block_ms_count_outermost_ranges_per_step():
    """The recompute's range nested in its backward's of the same name
    counts once."""
    inner = _ev("train.mamba", 1000.0)
    back = _ev("train.mamba", 2000.0, [inner])
    shared_in = _ev("train.shared", 500.0)
    outer_shared = _ev("train.shared", 3000.0, [shared_in])
    fwd = _ev("train.mamba", 1000.0)
    evs = [fwd, back, inner, outer_shared, shared_in]
    tr = Trace([], evs, 1.0, {"steps": 2})
    assert harness.load_metric("mamba_ms.train")(tr) == pytest.approx((1.0 + 3.0) / 2)
    assert harness.load_metric("shared_block_ms.train")(tr) == pytest.approx(3.5 / 2)
    none = Trace([], [], 1.0, {"steps": 2})
    assert harness.load_metric("mamba_ms.train")(none) is None
    assert harness.load_metric("shared_block_ms.train")(none) is None


def test_controls_and_faults_fail_the_limits():
    env = _env(2**31 + 11)
    judged = control.judge(runner, runner.control(env))
    assert judged.keys() == {"control_fp8", "control_bf16_ssd", "fault_half_batch",
                             "fault_state_unchanged", "fault_block0", "fault_no_e"}
    assert not any(r["correct"] for r in judged.values()), judged


def test_ssd_bwd_gap_sees_the_backward_products_not_the_storage():
    """``ssd_bwd_gaps`` against the reference's float32 gradients: the
    same gradients stored in bf16 (as the program stores dx, dB, dC) read
    under the runner's limit, the SSD's products in bf16 (autograd then
    takes bf16 for their gradients too) over it."""
    g = torch.Generator().manual_seed(5)
    b, T, H, P, G, N, chunk = 2, 64, 4, 8, 2, 8, 16
    x, dy = (torch.randn((b, T, H, P), generator=g) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, T, H), generator=g)) * 0.1
    A = -torch.exp(torch.randn((H,), generator=g))
    B, C = (torch.randn((b, T, G, N), generator=g) for _ in range(2))
    args = (x, dt, A, B, C, chunk, dy)

    def stored(grads):
        return {n: t.to(torch.bfloat16) if n in ("x", "B", "C") else t
                for n, t in grads.items()}
    sound = ref.ssd_bwd_gaps(*args, stored(ref.ssd_grads(*args, H // G)), H // G)
    bf16 = ref.ssd_bwd_gaps(*args, stored(ref.ssd_grads(*args, H // G, torch.bfloat16)),
                            H // G)
    assert max(sound.values()) < runner.LIMITS["ssd_bwd_gap"] < max(bf16.values()), (sound, bf16)


def test_mamba_and_shared_block_ms_count_a_kernel_once_under_two_host_events():
    """A kernel the profiler hangs under its launching operation and under
    the "Command Buffer Full" event CUPTI records inside it with the same
    id (the launch queue full) counts once."""
    op = _ev("aten::mm", 700.0)
    op.cpu_children = [_ev("Command Buffer Full", 700.0, id=op.id)]
    op.cpu_children[0].cpu_parent = op
    rng = _ev("train.mamba", 300.0, [op])
    shared_op = _ev("aten::mm", 50.0)
    twin = _ev("Command Buffer Full", 50.0, id=shared_op.id)
    shared = _ev("train.shared", 0.0, [shared_op, twin])
    evs = [rng, op, op.cpu_children[0], shared, shared_op, twin]
    tr = Trace([], evs, 1.0, {"steps": 1})
    assert harness.load_metric("mamba_ms.train")(tr) == pytest.approx(1.0)
    assert harness.load_metric("shared_block_ms.train")(tr) == pytest.approx(0.05)


def test_the_step_spans_are_disjoint_and_fit_in_the_step():
    """A profiled train step of the family on the CPU (remat on), each
    operation given a stand-in kernel of its own time, every third also
    under a "Command Buffer Full" twin of its id: no range of train.mamba,
    train.shared, train.ce and train.adamw nests in one of another name;
    the four, each kernel once, add up to at most the step's kernel time;
    the twins leave the two readers of this cell as they were."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.zamba2_7b import CONFIG
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from bench.spans import span_s
    cfg = CONFIG.smoke().replace(dtype="float32", remat=True)
    params = init_params(cfg, 4, device="cpu")
    b = gen.lm_batch(4, 0, 2, 32, cfg.vocab_size)
    batch = {k: torch.from_numpy(b[k]) for k in ("tokens", "labels")}
    step = make_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, adamw_init(params), batch)
    cpu = list(prof.events())
    names = ("train.mamba", "train.shared", "train.ce", "train.adamw")
    for ev in cpu:
        if ev.name in names:
            up = ev.cpu_parent
            while up is not None:
                assert up.name == ev.name or up.name not in names, (ev.name, up.name)
                up = up.cpu_parent
    ops = [ev for ev in cpu if ev.name.startswith("aten::") and not ev.cpu_children]
    for ev in ops:
        ev.kernels.append(SimpleNamespace(name="kernel of " + ev.name,
                                          duration=ev.self_cpu_time_total))
    kernels = [(k.name, ev.time_range.start, ev.time_range.start + k.duration)
               for ev in ops for k in ev.kernels]
    total = sum(e - a for _, a, e in kernels) / 1e6
    tr = Trace(kernels, cpu, 1.0, {"steps": 1})
    read_m = harness.load_metric("mamba_ms.train")
    read_s = harness.load_metric("shared_block_ms.train")
    before = read_m(tr), read_s(tr)
    parts = [span_s(tr, n) for n in names]
    assert all(parts) and sum(parts) <= total * (1 + 1e-9), (parts, total)
    for ev in ops[::3]:
        twin = SimpleNamespace(name="Command Buffer Full", id=ev.id, cpu_parent=ev,
                               cpu_children=[], kernels=list(ev.kernels))
        ev.cpu_children.append(twin)
        cpu.append(twin)
    assert (read_m(tr), read_s(tr)) == before
    assert tr.span_s("train.mamba") > before[0] / 1e3


def test_tiny_run_prints_the_contract_keys():
    """The cell at a tiny size in a fresh process, plain and traced: the
    result line has exactly the contract's keys, the run is correct, and
    nothing of JAX or the JAX package was loaded."""
    script = (
        "import json, sys, time\n"
        "t = time.perf_counter()\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from bench import harness\n"
        "from bench.tests import tiny_zamba2\n"
        "for trace in (False, True):\n"
        f"    out = harness.run_cell({CELL!r}, 2**31 + 7, 0.5, trace, t_process=t,\n"
        "        device=torch.device('cpu'), overrides=tiny_zamba2.overrides())\n"
        "    print(json.dumps(out))\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    lines = _run(script).strip().splitlines()
    plain, traced = [json.loads(x) for x in lines if x.startswith("{")]
    assert json.loads(lines[-1]) == []
    assert set(plain) == KEYS and set(traced) == KEYS | {"breakdown"}
    assert list(plain)[-1] == "checks" and list(traced)[-1] == "checks"
    for out in (plain, traced):
        assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
        assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert "setup_s" in plain["metrics"] and len(plain["metrics"]) >= 2
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_reference_and_counts_load_nothing_of_the_program():
    script = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import bench.reference.zamba2, bench.counts.zamba2\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = set(json.loads(_run(script).strip().splitlines()[-1]))
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
