"""PSO hyperparameter search.

The reference shipped a non-runnable pyswarms sketch (5+ syntax errors,
ref: hyperparameter_tuning.py — SURVEY.md §2.7) — its SEARCH SPACE is the
spec, not its code. This module implements global-best PSO from scratch
(numpy; pyswarms is not a dependency) with the sketch's exact swarm settings
(18 particles, 25 iterations, c1=c2=1.5, w=0.6, ref:
hyperparameter_tuning.py:134-145) over the same 9-dim space
(ref: :105-132):

  [model_type, d_model, n_head, n_layers, ffn_hidden, drop_prob,
   learning_rate, batch_size, patch_or_segment_size]

Fitness = negative validation accuracy after a short jitted training run
(the sketch's `fast_train` did ONE batch; configurable here). Continuous
particle positions are DECODED to valid architectures (d_model snapped to a
multiple of n_head, patch/segment snapped to legal divisors) — the sketch
would have crashed on most of its own search space.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# bounds from the reference sketch (hyperparameter_tuning.py:105-132)
MIN_BOUNDS = np.array([0, 32, 2, 1, 64, 0.0, 1e-5, 16, 4], dtype=np.float64)
MAX_BOUNDS = np.array([1, 512, 16, 8, 2048, 0.4, 5e-3, 128, 64], dtype=np.float64)
DIM = 9


def _snap(v, grid):
    return min(grid, key=lambda g: abs(g - v))


def decode_particle(p: np.ndarray, bucket: bool = False) -> Dict:
    """Continuous position -> valid hyperparameter dict.

    bucket=True additionally snaps every SHAPE-AFFECTING dimension to a
    coarse grid so particles collide onto shared architectures. This is what
    makes the sweep viable on an accelerator: each distinct architecture costs one XLA
    compile (minutes through this environment's remote AOT service), and the
    fitness memoizes compiled steps per architecture — with bucketing, the
    swarm's 18x26 evaluations collapse onto a few dozen compiles instead of
    ~468. The learning rate stays CONTINUOUS: it is an injected state scalar
    (vitiq/train/optim.py), so it never triggers recompilation.
    """
    model_type = int(round(np.clip(p[0], 0, 1)))  # 0 = vit, 1 = rawiq
    n_head = int(np.clip(round(p[2]), 2, 16))
    d_model = int(np.clip(round(p[1]), 32, 512))
    n_layers = int(np.clip(round(p[3]), 1, 8))
    ffn_hidden = int(np.clip(round(p[4]), 64, 2048))
    drop_prob = float(np.clip(p[5], 0.0, 0.4))
    lr = float(np.clip(p[6], 1e-5, 5e-3))
    batch_size = int(np.clip(round(p[7]), 16, 128))
    size = int(np.clip(round(p[8]), 4, 64))
    if bucket:
        n_head = _snap(n_head, (2, 4, 8, 16))
        d_model = _snap(d_model, (32, 64, 128, 256, 512))
        ffn_hidden = _snap(ffn_hidden, (64, 128, 256, 512, 1024, 2048))
        batch_size = _snap(batch_size, (16, 32, 64, 128))
        drop_prob = round(drop_prob * 20) / 20  # 0.05 grid (a jit constant)
    d_model = max(n_head, (d_model // n_head) * n_head)  # divisibility
    if model_type == 0:
        # patch must divide 32 and 64 -> {4, 8, 16, 32}
        patch = min((4, 8, 16, 32), key=lambda v: abs(v - size))
        arch = {"arm": "vit", "patch_size": patch}
    else:
        # segment must divide 1024 -> snap to nearest power of two in range
        seg = min((4, 8, 16, 32, 64), key=lambda v: abs(v - size))
        arch = {"arm": "rawiq", "segment_size": seg}
    return {
        **arch,
        "d_model": d_model, "n_head": n_head, "n_layers": n_layers,
        "ffn_hidden": ffn_hidden, "drop_prob": drop_prob,
        "learning_rate": lr, "batch_size": batch_size,
    }


@dataclass
class PSOResult:
    best_position: np.ndarray
    best_cost: float
    best_hparams: Dict
    cost_history: List[float]
    evaluations: int


def global_best_pso(
    fitness: Callable[[np.ndarray], np.ndarray],
    n_particles: int = 18,
    iters: int = 25,
    c1: float = 1.5,
    c2: float = 1.5,
    w: float = 0.6,
    seed: int = 0,
    bounds: Tuple[np.ndarray, np.ndarray] = (MIN_BOUNDS, MAX_BOUNDS),
    verbose: bool = False,
    on_iter: Optional[Callable] = None,
    init_state: Optional[Dict] = None,
) -> PSOResult:
    """Canonical global-best PSO; `fitness(X[n_particles, dim]) -> cost[n]`.
    `on_iter(it, gbest_x, gbest_cost, history, swarm_state)` fires after each
    iteration — long on-chip sweeps use it to persist the partial trace
    including the FULL swarm state; passing that dict back as `init_state`
    resumes the trajectory exactly (round 5: interrupted sweeps continue
    instead of restarting)."""
    rng = np.random.default_rng(seed)
    lo, hi = bounds
    dim = len(lo)
    if init_state is not None:
        x = np.asarray(init_state["x"], np.float64)
        v = np.asarray(init_state["v"], np.float64)
        pbest_x = np.asarray(init_state["pbest_x"], np.float64)
        pbest_cost = np.asarray(init_state["pbest_cost"], np.float64)
        gbest_x = np.asarray(init_state["gbest_x"], np.float64)
        gbest_cost = float(init_state["gbest_cost"])
        history = list(init_state["history"])
        start_it = int(init_state["iters_done"])
        evals = int(init_state.get("evaluations", (start_it + 1) * n_particles))
        rng.bit_generator.state = init_state["rng_state"]
    else:
        x = rng.uniform(lo, hi, (n_particles, dim))
        v = np.zeros_like(x)
        pbest_x = x.copy()
        pbest_cost = fitness(x)
        g = int(np.argmin(pbest_cost))
        gbest_x, gbest_cost = pbest_x[g].copy(), float(pbest_cost[g])
        history = [gbest_cost]
        evals = n_particles
        start_it = 0

    for it in range(start_it, iters):
        r1 = rng.random((n_particles, dim))
        r2 = rng.random((n_particles, dim))
        v = w * v + c1 * r1 * (pbest_x - x) + c2 * r2 * (gbest_x - x)
        x = np.clip(x + v, lo, hi)
        cost = fitness(x)
        evals += n_particles
        improved = cost < pbest_cost
        pbest_x[improved] = x[improved]
        pbest_cost[improved] = cost[improved]
        g = int(np.argmin(pbest_cost))
        if pbest_cost[g] < gbest_cost:
            gbest_cost = float(pbest_cost[g])
            gbest_x = pbest_x[g].copy()
        history.append(gbest_cost)
        if verbose:
            print(f"pso iter {it + 1}/{iters}: best_cost={gbest_cost:.4f}",
                  flush=True)
        if on_iter is not None:
            swarm_state = {
                "x": x.tolist(), "v": v.tolist(),
                "pbest_x": pbest_x.tolist(),
                "pbest_cost": pbest_cost.tolist(),
                "gbest_x": gbest_x.tolist(), "gbest_cost": gbest_cost,
                "history": history, "iters_done": it + 1,
                "evaluations": evals,
                "rng_state": rng.bit_generator.state,
            }
            on_iter(it, gbest_x, gbest_cost, history, swarm_state)

    # decode only applies to the 9-dim AMC space; generic optimizations
    # (tests, other spaces) get the raw position
    hparams = decode_particle(gbest_x) if dim == DIM else {}
    return PSOResult(gbest_x, gbest_cost, hparams, history, evals)


# --------------------------------------------------------------------------
# fitness: short training run
# --------------------------------------------------------------------------

def make_amc_fitness(
    train_data, valid_data, num_classes: int, seq_length: int,
    train_steps: int = 30, eval_batches: int = 4, seed: int = 0,
    bucket: bool = False,
) -> Callable[[np.ndarray], np.ndarray]:
    """Fitness for the AMC search space: -val_accuracy after `train_steps`
    jitted steps (the sketch's fast_train, fixed: real forward on batches,
    correct variable names — ref bugs catalogued in SURVEY.md §2.7).

    Round 5 (VERDICT r4 item 3): the whole fast-train runs as ONE scanned
    device call per evaluation (batches index-gathered from the device-
    resident corpus — the refscale train_chunk pattern), and the eval pass
    scans the FULL valid split. Per-step dispatch cost made the round-4
    sweep's 30-step budget both slow AND too weak to rank architectures (best 9.4% vs 5.3% random after 122
    architectures); scanning makes a 400-step budget cost roughly one
    dispatch, so the budget that actually discriminates (see
    scripts/pso_calibrate.py) is affordable.

    Compiled train/eval programs are MEMOIZED per architecture (everything
    shape-affecting; the learning rate is excluded because it is injected
    state, vitiq/train/optim.py) — revisited architectures cost zero
    compiles. Combine with bucket=True (see decode_particle) on accelerators.
    The returned callable exposes `.compile_cache` for introspection and
    `.eval_hp(hp, seed=...)` for direct architecture evaluation (the
    calibration harness drives it)."""
    import functools

    import jax
    import jax.numpy as jnp

    from vitiq.config import ModelConfig, TrainConfig
    from vitiq.dsp import preprocess_batch_rawiq, preprocess_batch_vit
    from vitiq.models import init_amc_params, make_forward
    from vitiq.ops.metrics import accuracy as _acc_fn
    from vitiq.ops.metrics import label_smoothed_cross_entropy
    from vitiq.train.optim import (TrainState, create_train_state,
                                   make_optimizer, set_learning_rate)

    x_train, y_train = train_data
    x_valid, y_valid = valid_data
    stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
    # one-time device residency: the sweep corpus is small (tens of MB)
    xd_tr = jnp.asarray(np.asarray(x_train, np.float32))
    yd_tr = jnp.asarray(np.asarray(y_train, np.int32))
    xd_va = jnp.asarray(np.asarray(x_valid, np.float32))
    yd_va = jnp.asarray(np.asarray(y_valid, np.int32))
    n_va = int(xd_va.shape[0])
    compile_cache: Dict[tuple, tuple] = {}

    def compiled_for(hp: Dict):
        key = tuple(sorted((k, v) for k, v in hp.items() if k != "learning_rate"))
        if key in compile_cache:
            return compile_cache[key]
        if hp["arm"] == "vit":
            # fold the IQ frame into the largest image that fits the frame
            h, w = 32, (2 * seq_length) // 32
            cfg = ModelConfig(arm="vit", num_classes=num_classes,
                              d_model=hp["d_model"], n_head=hp["n_head"],
                              n_layers=hp["n_layers"], ffn_hidden=hp["ffn_hidden"],
                              drop_prob=hp["drop_prob"], img_size_h=h, img_size_w=w,
                              patch_size=hp["patch_size"], seq_length=seq_length)
            pre = lambda x: preprocess_batch_vit(x, stats, H=h, W=w)
        else:
            cfg = ModelConfig(arm="rawiq", num_classes=num_classes,
                              d_model=hp["d_model"], n_head=hp["n_head"],
                              n_layers=hp["n_layers"], ffn_hidden=hp["ffn_hidden"],
                              drop_prob=hp["drop_prob"], seq_length=seq_length,
                              segment_size=hp["segment_size"])
            pre = lambda x: preprocess_batch_rawiq(x, stats)
        # learning_rate here is only the tx template's initial value; each
        # evaluation overwrites it in the state (inject_hyperparams)
        tcfg = TrainConfig(batch_size=hp["batch_size"], learning_rate=hp["learning_rate"])
        fwd = make_forward(cfg)
        tx = make_optimizer(tcfg)
        smoothing = tcfg.label_smoothing
        bs = hp["batch_size"]

        @functools.partial(jax.jit, donate_argnums=(0,))
        def fast_train(state, idx, rng):
            """idx [steps, bs] int32 gathers batches from the resident
            corpus; the whole budget is ONE device call."""

            def body(st, bi):
                x = jnp.take(xd_tr, bi, axis=0)
                y = jnp.take(yd_tr, bi, axis=0)
                inputs = pre(x)
                drng = jax.random.fold_in(rng, st.step)

                def loss_fn(p):
                    logits = fwd(p, inputs, train=True, rng=drng)
                    return label_smoothed_cross_entropy(logits, y, smoothing)

                loss, grads = jax.value_and_grad(loss_fn)(st.params)
                updates, opt_state = tx.update(grads, st.opt_state, st.params)
                new_p = jax.tree_util.tree_map(lambda p, u: p + u,
                                               st.params, updates)
                return TrainState(params=new_p, opt_state=opt_state,
                                  step=st.step + 1), loss

            state, losses = jax.lax.scan(body, state, idx)
            return state, losses[-1]

        bs_e = min(bs, n_va)  # tiny CPU-test corpora can be < one batch
        va_steps = max(n_va // bs_e, 1)

        @jax.jit
        def fast_eval(params):
            def body(carry, i):
                sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * bs_e, bs_e, 0)
                logits = fwd(params, pre(sl(xd_va)), train=False)
                return carry + _acc_fn(logits, sl(yd_va)), None

            total, _ = jax.lax.scan(body, jnp.zeros(()),
                                    jnp.arange(va_steps))
            return total / va_steps

        compile_cache[key] = (cfg, tcfg, fast_train, fast_eval)
        return compile_cache[key]

    def eval_one(hp: Dict, eval_seed: Optional[int] = None) -> float:
        s = seed if eval_seed is None else eval_seed
        cfg, tcfg, fast_train, fast_eval = compiled_for(hp)
        params = init_amc_params(jax.random.PRNGKey(s), cfg)
        state = create_train_state(params, tcfg)
        state = set_learning_rate(state, hp["learning_rate"])
        bs = hp["batch_size"]
        idx = np.random.default_rng(s).integers(
            0, len(x_train), (train_steps, bs)).astype(np.int32)
        state, _last_loss = fast_train(state, jnp.asarray(idx),
                                       jax.random.PRNGKey(s))
        return float(fast_eval(state.params))

    def fitness(X: np.ndarray) -> np.ndarray:
        costs = np.empty(len(X))
        for i, p in enumerate(X):
            hp = decode_particle(p, bucket=bucket)
            try:
                acc = eval_one(hp)
            except (ValueError, RuntimeError) as e:
                print(f"particle {i} invalid ({e}); penalizing")
                acc = 0.0
            costs[i] = -acc
        return costs

    fitness.compile_cache = compile_cache
    fitness.eval_hp = eval_one
    return fitness


def run_pso_sweep(
    n_particles: int = 18,
    iters: int = 25,
    seed: int = 0,
    train_steps: int = 30,
    source: str = "synthetic",
    file_path: Optional[str] = None,
    json_path: Optional[str] = None,
    output_path: Optional[str] = None,
    frames_per_class: int = 512,
    frame_len: int = 256,
    verbose: bool = True,
    bucket: Optional[bool] = None,
    classes: Optional[Tuple[str, ...]] = None,
    channel: bool = False,
    resume_path: Optional[str] = None,
) -> Dict:
    """End-to-end sweep over the 9-dim reference search space.

    `bucket` defaults to True on accelerator backends (architecture
    bucketing + per-architecture compile memoization keep the sweep to a
    few dozen compiles instead of one per evaluation — see decode_particle)
    and False on the CPU (its compiles are cheap; the unbucketed space is
    the reference sketch's exact search space).

    `resume_path`: a partial-trace JSON written by a previous run (the
    per-iteration artifact embeds the full swarm state) — the sweep
    continues its exact trajectory from the recorded iteration."""
    if bucket is None:
        import jax

        bucket = jax.default_backend() != "cpu"
    init_state = None
    if resume_path and Path(resume_path).exists():
        prev = json.loads(Path(resume_path).read_text())
        if prev.get("partial") and prev.get("swarm_state"):
            init_state = prev["swarm_state"]
            # numpy Generator state restoration wants the exact dict shape
            init_state["rng_state"] = prev["swarm_state"]["rng_state"]
            if verbose:
                print(f"resuming sweep from iteration "
                      f"{init_state['iters_done']}", flush=True)
    if source == "synthetic":
        from vitiq.data import ChannelModel, SyntheticAMCDataset

        ds = SyntheticAMCDataset(classes=classes or ("BPSK", "QPSK", "16QAM"),
                                 frames_per_class=frames_per_class,
                                 frame_len=frame_len, seed=seed,
                                 channel=ChannelModel() if channel else None)
        n = len(ds)
        split = int(0.85 * n)
        train, valid = (ds.X[:split], ds.Y[:split]), (ds.X[split:], ds.Y[split:])
        num_classes, seq_length = len(ds.classes), frame_len
    else:
        from vitiq.config import DataConfig
        from vitiq.data import HDF5DataSource

        dcfg = DataConfig(source="hdf5", file_path=file_path, json_path=json_path)
        src = HDF5DataSource(file_path, json_path)
        s = src.split(dcfg)
        x_t, y_t, _ = src.load_split_arrays(s.train[:20000], s.label_map)
        x_v, y_v, _ = src.load_split_arrays(s.valid[:4000], s.label_map)
        src.close()
        train, valid = (x_t, y_t), (x_v, y_v)
        num_classes, seq_length = len(dcfg.target_modulations), x_t.shape[1]

    fitness = make_amc_fitness(train, valid, num_classes, seq_length,
                               train_steps=train_steps, seed=seed, bucket=bucket)

    def persist_partial(it, gx, gc, hist, swarm_state):
        if not output_path:
            return
        Path(output_path).write_text(json.dumps({
            "partial": True, "iters_done": it + 1,
            "best_val_accuracy": -gc,
            "best_hparams": decode_particle(gx, bucket=bucket),
            "cost_history": hist,
            "distinct_architectures_compiled": len(fitness.compile_cache),
            "train_steps": train_steps,
            "swarm_state": swarm_state,
        }, indent=2, default=float))

    result = global_best_pso(fitness, n_particles=n_particles, iters=iters,
                             seed=seed, verbose=verbose,
                             on_iter=persist_partial, init_state=init_state)
    out = {
        "best_val_accuracy": -result.best_cost,
        "best_hparams": result.best_hparams,
        "cost_history": result.cost_history,
        "evaluations": result.evaluations,
        "distinct_architectures_compiled": len(fitness.compile_cache),
        "bucketed": bucket,
        "train_steps": train_steps,
        "partial": False,
    }
    if output_path:
        Path(output_path).write_text(json.dumps(out, indent=2, default=float))
    return out
