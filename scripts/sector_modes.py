"""Dense vs length-sorted sector sweeps on the card: the data behind "auto".

    python scripts/sector_modes.py [--out FILE.json]   # needs a GPU; ~5 min

Prints one JSON line per measurement, and with ``--out`` also writes them
all, with the card's name and power limit, to one JSON file:

  * capacity ladder: forward time of ``dense`` vs ``sorted_pt@2048`` at
    4096 agents x 1080 beams on levine (K=32) and on berlin tables built
    at shorter cull ranges (smaller padded capacity K), values compared;
  * the flagship tables (levine, berlin at 10 m): forward and
    forward+backward of both modes, plus sorted-sweep variants forward;
  * agent chunking: 32k and 65k berlin agents in 16384-agent chunks vs
    one shot, values compared and both timed.

Times are the median of ``REPS`` dispatches, each ended by
``block_until_ready``, after one warm-up call (compilation excluded).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

A, B, FOV = 4096, 1080, 4.712388980384690
REPS = 10


def timed(fn, *args) -> float:
    """Median seconds per call (module doc)."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def sweep_fns(smap, mode: str, chunk: int, max_range: float):
    """(fwd, fwd+bwd) jitted scans in ``mode`` with an explicit slot
    chunk — the body of ops.raycast_sectors.scan_poses_sectors, without
    agent chunking."""
    import jax
    import jax.numpy as jnp
    from pyracecarsimulator_tpu.ops.common import fan_cos_sin
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        _padded_offsets, _scan_chunk, sector_block_width)
    bb = sector_block_width(smap, B, FOV)
    offs = _padded_offsets(B, FOV, bb)

    def scan(sm, poses):
        ct, st = fan_cos_sin(poses[:, 2], offs)
        return _scan_chunk(sm, poses, ct, st, B, max_range, bb, mode,
                           chunk)

    fwd = jax.jit(scan)
    fb = jax.jit(jax.grad(lambda sm, p: jnp.sum(scan(sm, p)), argnums=1))
    return fwd, fb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        raise RuntimeError("sector_modes.py measures the card; no GPU found")
    from pyracecarsimulator_tpu.maps.loader import (load_builtin,
                                                    sample_free_poses)
    from pyracecarsimulator_tpu.maps.sectors import build_sector_map
    from pyracecarsimulator_tpu.ops.raycast_sectors import (
        resolve_sector_mode, scan_poses_sectors)
    from pyracecarsimulator_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rec = {"card": card, "kind": jax.devices()[0].device_kind,
           "agents": A, "beams": B, "reps": REPS, "rows": []}
    print(f"card: {card}", flush=True)

    def row(**kw):
        rec["rows"].append(kw)
        print(json.dumps(kw), flush=True)

    tracks = {n: load_builtin(n) for n in ("levine", "berlin")}
    poses = {n: jnp.asarray(sample_free_poses(t, A, np.random.RandomState(0)))
             for n, t in tracks.items()}

    def smap_of(name, max_range):
        t = tracks[name]
        return build_sector_map(np.asarray(t.occupancy), t.resolution,
                                (t.origin_x, t.origin_y),
                                max_range=max_range, tile_size=2.0, ns=16,
                                real_hw=(t.height, t.width))

    # capacity ladder (forward)
    flagship = {}
    for name, mr in (("levine", 10.0), ("berlin", 1.0), ("berlin", 2.0),
                     ("berlin", 4.0), ("berlin", 10.0)):
        sm = smap_of(name, mr)
        if mr == 10.0:
            flagship[name] = sm
        k = sm.table.shape[2]
        out = {}
        for mode in ("dense", "sorted_pt@2048"):
            fwd, _ = sweep_fns(sm, mode, 64, mr)
            out[mode] = (timed(fwd, sm, poses[name]),
                         np.asarray(fwd(sm, poses[name])))
        m = np.asarray(sm.meta)
        row(kind="ladder", map=name, max_range=mr, K=k,
            table_mean=float((m[:, 0] + m[:, 2] - m[:, 1]).mean()),
            dense_s=out["dense"][0], sorted_pt_s=out["sorted_pt@2048"][0],
            speedup=out["dense"][0] / out["sorted_pt@2048"][0],
            maxabs=float(np.abs(out["dense"][1]
                                - out["sorted_pt@2048"][1]).max()),
            auto=resolve_sector_mode("auto"))

    # flagship tables: fwd + fwd+bwd, and sorted-sweep variants (fwd)
    for name, sm in flagship.items():
        for mode, chunk in (("dense", 64), ("sorted_pt@2048", 64),
                            ("sorted_pt@2048", 32), ("sorted_pt@512", 32),
                            ("sorted_ptt@2048", 32), ("sorted@256", 32)):
            fwd, fb = sweep_fns(sm, mode, chunk, 10.0)
            r = dict(kind="flagship", map=name, mode=mode, chunk=chunk,
                     fwd_s=timed(fwd, sm, poses[name]))
            if chunk == 64:
                r["fwdbwd_s"] = timed(fb, sm, poses[name])
            r["fwd_rays_s"] = A * B / r["fwd_s"]
            row(**r)

    # agent chunking at 32k / 65k berlin agents (auto mode)
    sm = flagship["berlin"]
    for n in (32768, 65536):
        p = jnp.asarray(sample_free_poses(tracks["berlin"], n,
                                          np.random.RandomState(1)))
        fns = {c: jax.jit(lambda s, q, c=c: scan_poses_sectors(
            s, q, num_beams=B, fov=FOV, agent_chunk=c))
            for c in (16384, 0)}
        r_chunked = np.asarray(fns[16384](sm, p))
        r_one = np.asarray(fns[0](sm, p))
        row(kind="chunking", map="berlin", agents=n,
            chunked_16384_s=timed(fns[16384], sm, p),
            one_shot_s=timed(fns[0], sm, p),
            maxabs=float(np.abs(r_chunked - r_one).max()),
            peak_bytes=jax.devices()[0].memory_stats().get(
                "peak_bytes_in_use"))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
