"""The traced run's record: spans around the program's layer entry points,
host synchronisations by window step, and one profiler window.

Spans wrap the entry points where the program's drivers look them up, each
between two synchronisations (so a traced run is slower than an untraced
one: the spans stop the program from overlapping one layer's host work with
another's device work).  Host synchronisations are counted with
torch.cuda.set_sync_debug_mode("warn"), the harness's own left out.  The
profiler window covers three consecutive nodes at the middle of the first
window cone: device time by operation, the union of device activity against
the window's wall, and the longest idle gaps, each named by the host
operation that overlapped it most.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from pathlib import Path

from . import cells

# (module path below py21cmfast_torch, attribute, layer); a class attribute
# is given as "module:Class"
SPANS = (
    ("models.perturb", "perturb_field", "perturb"),
    ("models.spintemp", "compute_spin_temperature", "Ts"),
    ("models.ionization", "compute_ionization_field", "ionize"),
    ("drivers.coeval", "brightness_temperature", "Tb"),
    ("lightconers:RectilinearLightconer", "make_lightcone_slices", "slices"),
    ("rsds", "include_dvdr_in_tau21", "dvdr"),
    ("rsds", "apply_rsds", "RSDs"),
)
NODE_STAGES = ("perturb", "Ts", "ionize", "Tb", "slices")
PROFILED_NODES = 3


def _owner(path: str):
    import importlib

    module, _, cls = path.partition(":")
    obj = importlib.import_module(f"py21cmfast_torch.{module}")
    return getattr(obj, cls) if cls else obj


class Tracer:
    """Spans, sync counts and the profiler window of one traced run."""

    def __init__(self, dev):
        self.dev = dev
        self.spans = []  # (layer, cone, node or None, seconds)
        self.steps = []  # (cone, node or None for the finalization, seconds, host syncs)
        self.cone = None
        self.node = None
        self.cones = 0
        self.profile = None  # {"prof", "cone", "first", "walls"}
        self._caught = None
        self._t0 = None
        self._here = str(cells.BENCH_DIR)

    def sync(self):
        if self.dev.type == "cuda":
            import torch

            torch.cuda.synchronize(self.dev)

    def _span(self, layer, fn):
        def run(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.sync()
                self.spans.append((layer, self.cone, self.node, time.perf_counter() - t0))
        return run

    @contextlib.contextmanager
    def installed(self):
        """Wrap each layer's entry point where the drivers call it, and count
        host synchronisations, for the duration of the window."""
        import torch

        saved = []
        for path, attr, layer in SPANS:
            owner = _owner(path)
            saved.append((owner, attr, owner.__dict__.get(attr)))
            setattr(owner, attr, self._span(layer, getattr(owner, attr)))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self._caught = caught
            if self.dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                if self.dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
                for owner, attr, fn in saved:
                    if fn is None:
                        delattr(owner, attr)
                    else:
                        setattr(owner, attr, fn)
                self._caught = None

    def _syncs(self) -> int:
        """Host synchronisations caught since the last call, the harness's
        own left out."""
        new = [w for w in self._caught
               if "synchroniz" in str(w.message) and not str(Path(w.filename).resolve())
               .startswith(self._here)]
        self._caught.clear()
        return len(new)

    # ---- driven by the window's loop ----
    def begin_cone(self, n_nodes: int):
        self.cone = self.cones
        self.cones += 1
        if self.cone == 0 and n_nodes >= 1:
            first = max(0, n_nodes // 2 - PROFILED_NODES // 2)
            self.profile = {"cone": 0, "first": first,
                            "last": min(n_nodes, first + PROFILED_NODES) - 1, "walls": []}

    def begin_step(self, node: int | None):
        """Before the generator's next step: node index, or None for the
        finalization."""
        self.node = node
        self.sync()
        self._syncs()
        p = self.profile
        if p is not None and node is not None and self.cone == p["cone"] and node == p["first"]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            p["prof"] = profile(activities=acts)
            p["prof"].start()
        self._t0 = time.perf_counter()

    def end_step(self):
        self.sync()
        wall = time.perf_counter() - self._t0
        self.steps.append((self.cone, self.node, wall, self._syncs()))
        p = self.profile
        if p is not None and "prof" in p and not p.get("done") and self.cone == p["cone"]:
            p["walls"].append(wall)
            if self.node == p["last"]:
                p["prof"].stop()
                p["done"] = True

    # ---- reduction ----
    def _device_window(self):
        """Device time by operation, busy and idle, kernels, idle gaps."""
        from torch.autograd import DeviceType

        p = self.profile
        if p is None or "prof" not in p:
            return None
        prof = p.pop("prof")
        events = prof.events()
        dev_ev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                        if e.device_type == DeviceType.CUDA)
        host_ev = [(e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU]
        wall_s = float(sum(p["walls"]))
        out = {"nodes": len(p["walls"]), "window_s": wall_s}
        if not dev_ev:
            return out
        by_name = collections.defaultdict(float)
        busy_us, end, gaps = 0.0, dev_ev[0][0], []
        kernels = 0
        for s, e, name in dev_ev:
            if s > end:
                gaps.append((s - end, end, s, name))
            busy_us += max(0.0, e - max(s, end))
            end = max(end, e)
            by_name[name] += (e - s) / 1e6
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
        gaps.sort(reverse=True)
        named = []
        for dur, g0, g1, nxt in gaps[:10]:
            best, best_ov, best_len = None, 0.0, float("inf")
            for s, e, name in host_ev:
                ov = min(e, g1) - max(s, g0)
                if ov > best_ov or (ov == best_ov and ov > 0 and e - s < best_len):
                    best, best_ov, best_len = name, ov, e - s
            named.append([f"host {best or 'idle'} -> {nxt}"[:160], dur / 1e6])
        dep = [(t, n) for n, t in by_name.items() if "cic_deposit" in n]
        dep_calls = sum(1 for _, _, n in dev_ev if "cic_deposit" in n)
        out.update({
            "busy_s": busy_us / 1e6,
            "kernels": kernels,
            "device_ops": [[n[:160], t] for n, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": named,
            "deposit_s_per_call": (sum(t for t, _ in dep) / dep_calls) if dep_calls else None,
        })
        return out

    def record(self, ics_s: float, dim: int, hii_dim: int) -> dict:
        """The record every per-layer reader reads."""
        from . import card

        layer_s = collections.defaultdict(float)
        for layer, cone, node, s in self.spans:
            if cone is not None:
                layer_s[layer] += s
        node_steps = [st for st in self.steps if st[1] is not None]
        in_nodes = collections.defaultdict(float)
        for layer, cone, node, s in self.spans:
            if cone is not None and node is not None and layer in NODE_STAGES:
                in_nodes[layer] += s
        return {
            "ics_s": ics_s,
            "cones": self.cones,
            "nodes": len(node_steps),
            "layer_s": dict(layer_s),
            "node_wall_s": float(sum(st[2] for st in node_steps)),
            "node_stage_s": float(sum(in_nodes.values())),
            "node_host_syncs": int(sum(st[3] for st in node_steps)),
            "deposit_bound_s": card.deposit_bound_s(dim, hii_dim),
            "window": self._device_window(),
        }
