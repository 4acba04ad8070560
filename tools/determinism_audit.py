"""Where the port's results can change from one call to the next on the card.

    python3 tools/determinism_audit.py ops  [--out REPORT.json]
    python3 tools/determinism_audit.py loop [--out REPORT.json]

`ops`: PyTorch's candidate forms of a sum in a fixed order, on one NVIDIA
GPU, at the shapes of the loop stage's sums (the global BA's points and
poses, the essential graph's 7x7 blocks): `torch.segment_reduce(..., "sum",
offsets=...)` on the rows sorted by segment, `index_put_(...,
accumulate=True)` and, for the record, the atomic `index_add_`.  For each:
the same bits on three calls, the same bits as the CPU's `index_add_` (which
adds rows in order), no host synchronisation (`set_sync_debug_mode("error")`),
a CUDA graph capture whose replay gives the eager bits, and the time a call
(CUDA events).

`loop`: `chip_smoke.py`'s `system-loop` circuit through `System` under
`graphs.eager()` (every graphed body called, so every operation passes
PyTorch's dispatcher), with two listings:
- `torch.use_deterministic_algorithms(True, warn_only=True)`: PyTorch's
  warnings for the operations it ran that have no deterministic CUDA
  implementation, counted by message.  The setting is this tool's alone;
  nothing in the package sets it.  It does not list an operation for which
  the setting picks another, deterministic implementation (`index_add_` on
  the card becomes a sorted `index_put_`), so also:
- every scatter the run made (`index_add_`, `index_put_` and `x[i] = v`,
  `scatter*`, `index_copy_`, `put_`, `index_reduce_`), by the package's
  source line that called it, with its dtype and mode, how many calls wrote
  one target more than once, and of those how many wrote differing values
  there.  A float add that meets a target twice is an order-dependent sum
  on the card (atomics); a write of differing values to one target leaves
  the winner to the card.

Both print the card's name and power limit and one JSON line.
"""

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (label, segments, rows, components, rows kept, rows sorted by segment already)
OPS_SHAPES = (
    ("global BA points H_pp", 24576, 192 * 2 * 1024, 9, 0.35, False),
    ("global BA points b_p", 24576, 192 * 2 * 1024, 3, 0.35, False),
    ("distributed BA poses", 192, 192 * 2 * 1024, 48, 0.35, True),
    ("essential graph H blocks", 192 * 192, 4 * 2048, 49, 0.25, False),
)


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


def plan(key, S):
    """Rows sorted by segment (stable) and the segments' offsets; rows whose
    key is S (dropped) sort past offsets[S]."""
    order = torch.sort(key, stable=True).indices
    offsets = torch.searchsorted(key[order], torch.arange(S + 1, device=key.device))
    return order, offsets


def events_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def captured(fn):
    """(the replay's output, or the capture's error)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            out = fn()
    except Exception as e:  # noqa: BLE001  (the finding is the error)
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    g.replay()
    torch.cuda.synchronize()
    return out.clone(), None


def no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)


def audit_ops(dev):
    rng = np.random.RandomState(0)
    rows = []
    for label, S, N, D, kept, sorted_rows in OPS_SHAPES:
        idx = np.sort(rng.randint(0, S, N)) if sorted_rows else rng.randint(0, S, N)
        keep = rng.rand(N) < kept
        key_np = np.where(keep, idx, S)
        vals_np = rng.randn(N, D).astype(np.float32)
        key, vals = torch.from_numpy(key_np).to(dev), torch.from_numpy(vals_np).to(dev)
        order, offsets = plan(key, S)
        want = torch.zeros(S + 1, D).index_add_(0, torch.from_numpy(key_np), torch.from_numpy(
            vals_np))[:S]
        key_sorted = key[order]

        forms = {
            "segment_reduce": lambda: torch.segment_reduce(
                vals[order], "sum", offsets=offsets, unsafe=True),
            "index_put_accumulate": lambda: torch.zeros(S + 1, D, device=dev).index_put_(
                (key,), vals, accumulate=True)[:S],
            "index_add_": lambda: torch.zeros(S + 1, D, device=dev).index_add_(
                0, key_sorted, vals[order])[:S],
        }
        for name, fn in forms.items():
            outs = [fn() for _ in range(3)]
            torch.cuda.synchronize()
            graph_out, graph_err = captured(fn)
            row = {
                "shape": label, "form": name, "S": S, "N": N, "D": D,
                "rows_kept": int(keep.sum()),
                "same_bits_3_calls": all(torch.equal(outs[0], o) for o in outs[1:]),
                "spread_3_calls": max(float((outs[0] - o).abs().max()) for o in outs[1:]),
                "cpu_sequential_same_bits": torch.equal(outs[0].cpu(), want),
                "cpu_sequential_max_diff": float((outs[0].cpu() - want).abs().max()),
                "host_sync": no_sync(fn),
                "capture_error": graph_err,
                "replay_same_bits": (graph_out is not None and torch.equal(graph_out, outs[0])),
                "ms": events_ms(fn),
            }
            print(json.dumps(row))
            rows.append(row)
        # the plan itself: a stable sort and a search a solve, once
        plan_fn = lambda: plan(key, S)  # noqa: E731
        rows.append({"shape": label, "form": "plan (sort + searchsorted)",
                     "host_sync": no_sync(plan_fn), "ms": events_ms(plan_fn)})
        print(json.dumps(rows[-1]))
    return rows


SCATTER_OPS = ("index_add", "index_add_", "index_put", "index_put_", "_index_put_impl_",
               "_unsafe_index_put", "scatter", "scatter_", "scatter_add", "scatter_add_",
               "scatter_reduce", "scatter_reduce_", "index_copy", "index_copy_", "put", "put_",
               "index_reduce", "index_reduce_")


def _site():
    """The innermost frame in the port's package: 'path:line (function)'."""
    for fr in reversed(traceback.extract_stack()):
        if "multi_orb_slam_tpu_torch" in fr.filename:
            rel = fr.filename[fr.filename.rindex("multi_orb_slam_tpu_torch"):]
            return f"{rel}:{fr.lineno} ({fr.name})"
    return "outside the package"


def _targets(name, args, kwargs):
    """(flat target index of every value the call writes [n] int64 or None
    where a mask or a slice picks the targets, the values written [n, ...]
    or None for one scalar, a label of the mode)."""
    self = args[0]
    if name.startswith(("index_put", "_index_put", "_unsafe_index_put")):
        indices, values = args[1], args[2]
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        if any(i is None or i.dtype == torch.bool for i in indices):
            return None, None, f"accumulate={bool(acc)} (masked or sliced)"
        b = torch.broadcast_tensors(*indices)
        lin = torch.zeros_like(b[0], dtype=torch.int64)
        for d, i in enumerate(b):
            lin = lin * self.shape[d] + i.long() % self.shape[d]
        vals = values.expand(b[0].shape + self.shape[len(b):]).reshape(b[0].numel(), -1)
        return lin.reshape(-1), vals, f"accumulate={bool(acc)}"
    if name.startswith("put"):
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        return args[1].reshape(-1).long(), args[2].reshape(-1, 1), f"accumulate={bool(acc)}"
    dim, index = args[1] % self.dim(), args[2]
    src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) else None
    if name.startswith("index_"):
        base = name.rstrip("_")
        mode = ("add" if base == "index_add" else "copy" if base == "index_copy"
                else f"reduce={args[4]}")
        return index.long().reshape(-1), src.movedim(dim, 0).reshape(src.shape[dim], -1), mode
    # scatter*: the target is the index along dim, the value's own
    # coordinates along the other dims
    base = name.rstrip("_")
    mode = ("add" if base == "scatter_add" else f"reduce={args[4]}"
            if base == "scatter_reduce" else "write")
    grids = torch.meshgrid(*[torch.arange(n, device=index.device) for n in index.shape],
                           indexing="ij")
    lin = torch.zeros_like(index, dtype=torch.int64)
    for d in range(index.dim()):
        lin = lin * self.shape[d] + (index.long() if d == dim else grids[d])
    vals = None if src is None else src[tuple(slice(0, n) for n in index.shape)].reshape(-1, 1)
    return lin.reshape(-1), vals, mode


class Scatters(TorchDispatchMode):
    """Records every scatter on tensors of `device_type` into `table`:
    {(site, op, dtype, mode): {calls, repeats, differing}}."""

    def __init__(self, device_type="cuda"):
        super().__init__()
        self.device_type = device_type
        self.table = collections.defaultdict(lambda: {"calls": 0, "repeats": 0, "differing": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in SCATTER_OPS and args[0].device.type == self.device_type:
            with _disable_current_modes():
                lin, vals, mode = _targets(name, args, kwargs)
                rep, diff = (False, False) if lin is None else _repeats(lin, vals)
            row = self.table[(_site(), name, str(args[0].dtype).replace("torch.", ""), mode)]
            row["calls"] += 1
            row["repeats"] += rep
            row["differing"] += diff
        return func(*args, **kwargs)

    def rows(self):
        return [{"site": k[0], "op": k[1], "dtype": k[2], "mode": k[3], **v}
                for k, v in sorted(self.table.items())]


def _repeats(lin, vals):
    """(whether a target is written twice, whether two writes to one target
    differ in value)."""
    uniq, inv, counts = torch.unique(lin, return_inverse=True, return_counts=True)
    if uniq.numel() == lin.numel():
        return False, False
    if vals is None:
        return True, False
    v = vals.double().reshape(lin.numel(), -1)
    hi = torch.full((uniq.numel(), v.shape[1]), -float("inf"), dtype=v.dtype, device=v.device)
    lo = torch.full_like(hi, float("inf"))
    ix = inv[:, None].expand_as(v)
    hi.scatter_reduce_(0, ix, v, "amax")
    lo.scatter_reduce_(0, ix, v, "amin")
    return True, bool(((hi != lo) & (counts[:, None] > 1)).any())


def audit_loop(dev):
    import chip_smoke
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.placerec import database
    from multi_orb_slam_tpu_torch.utils import graphs

    calib, cfg, frames, _ = chip_smoke.loop_scene(dev)
    voc = chip_smoke.loop_vocabulary(frames, cfg)
    sys_ = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg)
    lc = sys_.loop_closer
    lc.voc, lc.db = voc, database.make_empty_db(cfg.max_kf, voc.n_words)
    seen = collections.Counter()
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        recorder = Scatters()
        with warnings.catch_warnings(record=True) as caught, graphs.eager(), recorder:
            warnings.simplefilter("always")
            for i, (g, d) in enumerate(frames):
                sys_.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0)
            sys_.shutdown()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for w in caught:
        seen[str(w.message).splitlines()[0][:300]] += 1
    scatters = recorder.rows()
    out = {"frames": len(frames), "seconds": time.perf_counter() - t0,
           "loops_closed": lc.n_loops_closed, "gba_merged": lc.n_gba_merged,
           "warnings": [{"message": m, "count": c} for m, c in seen.most_common()],
           "scatters": scatters}
    print(f"  {len(frames)} frames, loops closed {lc.n_loops_closed}, GBAs merged "
          f"{lc.n_gba_merged}, {out['seconds']:.1f} s; warnings of the deterministic setting:")
    for w in out["warnings"]:
        print(f"  {w['count']:>6} x {w['message']}")
    print("  scatters: calls, calls that wrote a target twice, of those with differing values")
    for r in scatters:
        print(f"  {r['calls']:>6} {r['repeats']:>6} {r['differing']:>6}  {r['op']} {r['dtype']} "
              f"{r['mode']}  {r['site']}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("ops", "loop"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("determinism_audit: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = card()
    print(f"nvidia-smi: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    result = {"card": name, args.what: audit_ops(dev) if args.what == "ops" else audit_loop(dev)}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"determinism_audit": args.what, "card": name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
