"""The instruction-issue floor of the brute-force triangle kernels, counted
from their SASS.

``kernel_costs(sass_text(library))`` gives, for each query of a built
``tri_intersect.cu`` ("closest", "record", "anyhit"), the instructions one
ray-triangle pair issues by how far its tests get; ``issue_floor_ms`` turns
them into the least time the card takes to issue the loop over given rays.
Used by ``chip_smoke.py`` (phase 3's log) and ``bench_tri_kernels.py``.
Every function raises where the listing is not what it expects.
"""
from __future__ import annotations

import re
import shutil
import statistics
import subprocess

import torch

from mitsuba_im_tpu_torch.accel import cuda_intersect as ci

# lane instructions issued per second on the H100 SXM: 132 SMs x 4
# schedulers x 32 lanes at the 1.98 GHz boost clock (one warp instruction
# per scheduler a cycle)
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9

_SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_SASS_BRA = re.compile(r"\bBRA\b[^;]*?(0x[0-9a-f]+)")


def sass_text(so):
    """``cuobjdump -sass`` of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


def sass_functions(text):
    """{function: [(address, instruction)]} of a ``cuobjdump -sass``
    listing, NOPs left out."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_OP.search(line)
        if m and cur is not None and not m.group(2).strip().startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def pair_costs(ops):
    """The instructions one ray-triangle pair issues in a brute-force
    kernel's loop over the triangles (``ops`` from :func:`sass_functions`),
    by how far it gets: (rejected after det, after u, after v, every test
    run).  The loop is the longest body of a backward branch; it holds one
    pair per MUFU.RCP (the compiler unrolls), and on the division's fast
    path the call of its slow path is skipped (a conditional branch to the
    MUFU.RCP).  A rejection is any other conditional forward branch in the
    body (to the pair's reconvergence point or its update), and skips what
    lies between; a kernel without such branches issues the whole pair
    every time, and one with a single test after the arithmetic skips only
    the update (counted as skipped for every pair).  Raises ValueError on
    any other loop shape."""
    loops = []
    for addr, op in ops:
        m = _SASS_BRA.search(op)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    if not loops:
        raise ValueError("no loop in the kernel's SASS")
    head, end = max(loops, key=lambda lp: lp[1] - lp[0])
    body = [(a, op) for a, op in ops if head <= a <= end]
    at = {a: j for j, (a, _) in enumerate(body)}
    pairs = sum(op.startswith("MUFU.RCP") for _, op in body)
    if not pairs:
        raise ValueError("no MUFU.RCP in the kernel's loop")
    slow, rejects = [], {}
    for j, (a, op) in enumerate(body):
        m = _SASS_BRA.search(op)
        if not (op.startswith("@") and m) or int(m.group(1), 16) not in at:
            continue
        k = at[int(m.group(1), 16)]
        if k <= j:
            continue
        if body[k][1].startswith("MUFU.RCP"):
            slow.append((j, k))
        else:
            rejects.setdefault(k, []).append(j)

    def skipped(j, k):  # fast-path instructions strictly between j and k
        return k - j - 1 - sum(e - s - 1 for s, e in slow if j < s < e <= k)

    full = (len(body) - sum(e - s - 1 for s, e in slow)) / pairs
    shape = {len(js) for js in rejects.values()}
    if not rejects:
        return (full,) * 4
    if len(rejects) != pairs or shape not in ({1}, {3}):
        raise ValueError(f"unexpected loop shape: {pairs} pairs, rejections "
                         f"{sorted(rejects.values())}")
    if shape == {1}:  # one test after all the arithmetic: it skips the
        # update; counted as skipped for every pair, hits too (a floor)
        miss = full - statistics.mean(skipped(js[0], k)
                                      for k, js in rejects.items())
        return (miss,) * 4
    return tuple(full - statistics.mean(skipped(sorted(js)[s], k)
                                        for k, js in rejects.items())
                 for s in range(3)) + (full,)


def kernel_costs(text):
    """{query: pair_costs} of a built library's SASS: "closest" (t, u, v,
    prim, found), "record" (the hit record, interface 2 only) and
    "anyhit"."""
    out = {}
    for name, ops in sass_functions(text).items():
        if "closest_kernel" in name:
            out["record" if "ILb1E" in name else "closest"] = pair_costs(ops)
        elif "anyhit_kernel" in name:
            out["anyhit"] = pair_costs(ops)
    if "closest" not in out or "anyhit" not in out:
        raise ValueError(f"no brute-force kernels in the SASS: {sorted(out)}")
    return out


def issue_floor_ms(tris, o, d, tmin, tmax, costs, any_hit):
    """The least time the card takes to issue the loop over the triangles
    on these rays, with the per-pair ``costs`` of :func:`pair_costs`: a
    warp of 32 consecutive rays issues, for each triangle, the cost of the
    furthest stage one of its rays reaches (the plain arithmetic decides
    the stage); in the any-hit kernel a ray leaves after its first blocking
    triangle.  Per-ray work outside the loop is not counted."""
    comps, n, dev = ci._rays(o, d, tmin, tmax)
    T = tris[0].shape[0]
    cost = torch.tensor((0.0,) + tuple(costs), dtype=torch.float64,
                        device=dev)
    k = torch.arange(T, device=dev)
    lanes = 0.0
    step = max(32, ci._CHUNK_ELEMS // T // 32 * 32)
    for a in range(0, n, step):
        r = [c[a:a + step, None] for c in comps]
        hit, _, u, v, ok = ci._moeller_trumbore(r[:7], *tris, r[7])
        stage = torch.where(~ok, 1, torch.where(
            ~((u >= 0.0) & (u <= 1.0)), 2, torch.where(
                ~((v >= 0.0) & (u + v <= 1.0)), 3, 4)))
        if any_hit:  # rays blocked by an earlier triangle have left
            first = torch.where(hit.any(1), hit.int().argmax(1), T)
            stage = torch.where(k[None] <= first[:, None], stage, 0)
        pad = (-stage.shape[0]) % 32
        stage = torch.cat([stage, stage.new_zeros(pad, T)])
        lanes += 32 * float(cost[stage.view(-1, 32, T).amax(1)].sum())
    return lanes / ISSUE_PER_S * 1e3
