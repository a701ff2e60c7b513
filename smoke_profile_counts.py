"""chip_smoke.py's phase 13 profile on its own: the device events of
consecutive profiled requests of CamLiRAFT-L at the eval CLI's batch of 8,
on the int8 form (CAMLIFLOW_UPDATE3D=1) and on the fast form, in a fresh
process, with the same weights, inputs and warm-up requests as phase 13.
Prints each profile's count of device events (kernels and copies) beside
the count chip_smoke.py's `device_kernels` keeps of them, with the events
it leaves out by kind (asynchronous, started and ended on different
threads, hidden) and by name; the port's wrapper counters; the first
profile's events by name and any later profile's difference from it by
name.

Run on a CUDA card from the root of a checkout: `python3
smoke_profile_counts.py TREE`, where TREE is the checkout whose package and
chip_smoke.py to use (`.`, or a parent unpacked by `git archive` into an
ignored directory)."""
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from camliflow_torch.csrc import build as kbuild  # noqa: E402
from camliflow_torch.models.camliraft_l import CamLiRAFTL  # noqa: E402
from camliflow_torch.runtime.checkpoint import random_weights  # noqa: E402
from camliflow_torch.runtime.evaluator import Evaluator  # noqa: E402
from camliflow_torch.utils.torch_setup import setup_torch  # noqa: E402

t0 = time.perf_counter()
setup_torch()
path, seconds, _ = kbuild.build()
kbuild.library()
print(f"tree {root}: built in {seconds:.1f} s", flush=True)
device = torch.device("cuda", 0)
wrappers = cs.kernel_wrappers()
model = CamLiRAFTL({**cs.L_CFGS, "fast_inference": "on"})
random_weights(model, cs.SEED)
ev = Evaluator(model, device)
singles = [cs.frame_pair(cs.SEED + 1 + i, i) for i in range(4)]
samples = [cs.frame_pair(cs.SEED + 20 + i, i) for i in range(cs.BATCH)]
batch = cs.stack(samples)


def one(label):
    for fn in wrappers.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.forward(batch)
        torch.cuda.synchronize()
    counts, left_out = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        kinds = [kind for kind, flag in (
            ("async", e.is_async()), ("cross-thread", e.start_thread_id() != e.end_thread_id()),
            ("hidden", getattr(e, "is_hidden_event", lambda: False)())) if flag]
        if kinds:
            key = f"[{'+'.join(kinds)}] {name}"
            left_out[key] = left_out.get(key, 0) + 1
        counts[name] = counts.get(name, 0) + 1
    kept = sum(k.count for k in cs.device_kernels(prof))
    mine = {k: f.launches for k, f in wrappers.items() if f.launches}
    return counts, mine, kept, left_out


for label, values in (("gated", {"CAMLIFLOW_UPDATE3D": "1"}), ("fast", {})):
    with cs.gated_switches(values):
        for x in singles + samples + [cs.stack(samples[:2]), batch, batch]:
            ev.forward(x)
        torch.cuda.synchronize()
        first = None
        for i in range(20 if label == "gated" else 8):
            counts, mine, kept, left_out = one(label)
            total = sum(counts.values())
            print(f"{label} profile {i}: {total} device events, device_kernels keeps {kept}; "
                  f"wrappers {sum(mine.values())}", flush=True)
            for k, v in sorted(left_out.items(), key=lambda kv: -kv[1])[:10]:
                print(f"    left out {v:5d}  {torch._C._demangle(k)[:150]}")
            if first is None:
                first = counts
                for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:40]:
                    print(f"    {v:5d}  {torch._C._demangle(k)[:150]}")
                continue
            diff = {k: counts.get(k, 0) - first.get(k, 0) for k in set(counts) | set(first)}
            diff = {k: v for k, v in diff.items() if v}
            for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:25]:
                print(f"    {v:+5d}  {torch._C._demangle(k)[:150]}")
print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
