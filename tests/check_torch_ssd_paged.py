"""The SSD-scan and paged-attention kernels against another checkout's, on
the card.

    mkdir -p build/against && git archive <commit> | tar -x -C build/against
    python3 tests/check_torch_ssd_paged.py build/against

Needs an NVIDIA H100 (sm_90a) and nvcc; not a test (pytest does not collect
it). Builds the other checkout's ``ssd_scan.cu`` and ``paged_attention.cu``
with the port's nvcc flags under ``build/ssd_paged_against/`` and this
tree's through ``kernels.build()``, and calls the other C entries by their
parameter names, read from its source (the split count and body where it
has them: the split body's own choice). At each shape it holds the other
build's outputs to this tree's within ``torch_cases.TOLS``, then times both
with ``chip_smoke.time_ms`` in turns (other, this, this, other):

* the SSD scan in float32 at mamba2-780m's serve shape (B 1, L 256, 48
  heads of 64, ds 128, chunk 64) and at L 2048, with this tree's kernel
  also at 16 state columns a block against its 32 (through its C entry),
  and built with ``-DSSD_CB_CLUSTER=2`` and ``=4`` (the blocks of a head
  in clusters that share C B^T) at 32 and 16 columns where hd / columns
  allows the cluster;
* paged attention at jamba-v0.1-52b's decode step (``PAGED_JAMBA``) in
  bfloat16 and float32, with this tree's serial body and its split body at
  clusters of 1, 2, 4 and 8, and the same at batch 4 (32 sequence x kv-head
  pairs).

It prints the card's name and power limit and one JSON line of the means.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]
import chip_smoke as cs  # noqa: E402
import torch_cases as tc  # noqa: E402
from repro_torch import compat, cuda_build, kernels  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402

OUT = ROOT / "build" / "ssd_paged_against"
ENTRIES = {"ssd_scan": "ssd_scan_launch",
           "paged_attention": "paged_attention_launch"}
KINDS = {"int": ctypes.c_int, "float": ctypes.c_float}


CLUSTERS = (2, 4)


def nvcc(src: Path, lib: Path, *flags: str) -> subprocess.Popen:
    """Start building ``src`` into ``lib`` with the port's nvcc flags."""
    return subprocess.Popen(
        [compat.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def finish(label: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode:
        sys.exit(f"nvcc failed on {label}:\n{log}")


class Other:
    """The SSD-scan and paged-attention kernels of another checkout, called
    by parameter name."""

    def __init__(self, root: Path):
        self.procs, self.fns, self.params, self.types = {}, {}, {}, {}
        for name in ENTRIES:
            src = root / "src/repro_torch/kernels" / name / "csrc" / f"{name}.cu"
            params = re.search(rf'extern "C" int {ENTRIES[name]}\(([^)]*)\)',
                               src.read_text()).group(1).split(",")
            self.params[name] = [p.split()[-1].lstrip("*") for p in params]
            self.types[name] = [ctypes.c_void_p if "*" in p
                                else KINDS[p.split()[0]] for p in params]
            self.procs[name] = nvcc(src, OUT / f"{name}.so")

    def load(self) -> None:
        """Wait for the builds and bind their C entries."""
        for name, proc in self.procs.items():
            finish(f"the other {name}", proc)
            fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), ENTRIES[name])
            fn.argtypes, fn.restype = self.types[name], ctypes.c_int
            self.fns[name] = fn

    def call(self, name: str, **values) -> None:
        values["stream"] = torch.cuda.current_stream().cuda_stream
        err = self.fns[name](*(values[p] for p in self.params[name]))
        if err:
            sys.exit(f"the other {name} failed to launch: error {err}")

    def ssd(self, xr, l, b, c, chunk: int, n_heads: int):
        bh, L, hd = xr.shape
        ds = b.shape[-1]
        y = torch.empty_like(xr)
        hT = torch.empty((bh, ds, hd), dtype=torch.float32, device=xr.device)
        self.call("ssd_scan", xr=xr.data_ptr(), l=l.data_ptr(),
                  b=b.data_ptr(), c=c.data_ptr(), y=y.data_ptr(),
                  hT=hT.data_ptr(), bh=bh, L=L, hd=hd, ds=ds, q=chunk,
                  n_heads=n_heads, bf16=int(xr.dtype == torch.bfloat16),
                  td=SK.column_tile(hd))
        return y, hT

    def paged(self, q, kp, vp, table, lens):
        bsz, kvh, g, hd = q.shape
        out = torch.empty_like(q)
        self.call("paged_attention", q=q.data_ptr(), kp=kp.data_ptr(),
                  vp=vp.data_ptr(), bt=table.data_ptr(), sl=lens.data_ptr(),
                  out=out.data_ptr(), bsz=bsz, kvh=kvh, g=g, hd=hd,
                  page=kp.shape[1], n_pages=table.shape[1], scale=hd ** -0.5,
                  bf16=int(q.dtype == torch.bfloat16),
                  split=int(PK.body(q, kp, vp) == "split"),
                  splits=PK.splits(bsz, kvh, table.shape[1] * kp.shape[1]))
        return out


def in_turns(launch: dict, reps: int) -> dict:
    """Mean ms of each ``launch[name]()``, in the order given and back."""
    names = list(launch)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cs.time_ms(launch[n], reps, 2))
    return {n: sum(t) / len(t) for n, t in times.items()}


def same(name: str, got, want, dname: str) -> None:
    torch.cuda.synchronize()
    tol = tc.TOLS[dname]
    for g, w in zip(got, want):
        if not torch.allclose(g.float(), w.float(), rtol=tol, atol=tol):
            sys.exit(f"{name}: the other build and this tree differ beyond "
                     f"rtol = atol = {tol}")


def show(label: str, row: dict) -> None:
    print(f"{label}: " + ", ".join(f"{n} {t:.4f}" for n, t in row.items())
          + " ms", flush=True)


def ssd_at_tile(lib, xr, l, b, c, chunk: int, n_heads: int, td: int):
    """One launch of an SSD library of this tree (``SK._library()`` or a
    cluster build) with ``td`` state columns a block (the wrapper takes
    ``kernel.column_tile``'s), float32."""
    bh, L, hd = xr.shape
    ds = b.shape[-1]
    y = torch.empty_like(xr)
    hT = torch.empty((bh, ds, hd), dtype=torch.float32, device=xr.device)
    err = lib.ssd_scan_launch(
        xr.data_ptr(), l.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), hT.data_ptr(), bh, L, hd, ds, chunk, n_heads, 0, td,
        torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"ssd_scan at {td} columns failed to launch: error {err}")
    return y, hT


def ssd(other: Other, clustered: dict) -> dict:
    out = {}
    for name, shape in (("serve", tc.SSD_SERVE), ("long", cs.SSD_LONG)):
        H, hd, chunk = shape[2], shape[3], shape[5]
        args = tc.ssd_kernel_inputs(shape, torch.float32, "cuda", seed=1)
        mine = lambda: SK.ssd_scan_kernel(*args, chunk=chunk, n_heads=H)
        lib = SK._library()
        same(f"ssd {name}", other.ssd(*args, chunk, H), mine(), "float32")
        same(f"ssd {name} at 16 columns",
             ssd_at_tile(lib, *args, chunk, H, 16), mine(), "float32")
        row = in_turns({"other": lambda: other.ssd(*args, chunk, H),
                        "this": mine}, 20)
        variants = {f"this_td{td}": lambda td=td: ssd_at_tile(
            lib, *args, chunk, H, td) for td in (16, 32)}
        for n, clib in clustered.items():
            for td in (16, 32):
                if (hd // td) % n == 0:
                    run = lambda clib=clib, td=td: ssd_at_tile(
                        clib, *args, chunk, H, td)
                    same(f"ssd {name} cluster {n} at {td} columns", run(),
                         mine(), "float32")
                    variants[f"cluster{n}_td{td}"] = run
        row.update(in_turns(variants, 20))
        row["bound"] = cs.ssd_bound(shape)[0]
        show(f"ssd_scan {name} {shape} float32", row)
        out[name] = row
    return out


def paged(other: Other) -> dict:
    s = tc.PAGED_JAMBA
    gen = torch.Generator(device="cuda").manual_seed(cs.KERNEL_TIME_SEED)
    out = {}
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        B, KVH, G, hd, page, P = (s["B"], s["KVH"], s["G"], s["hd"],
                                  s["page"], s["P"])
        npg = s["seq"] // page
        q = torch.randn((B, KVH, G, hd), generator=gen, device="cuda").to(dtype)
        kp, vp = (torch.randn((P, page, KVH, hd), generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        table = torch.randperm(P, generator=gen, device="cuda").to(
            torch.int32).reshape(B, npg)
        lens = torch.full((B,), s["seq"], dtype=torch.int32, device="cuda")
        for label, b in (("jamba", B), ("batch4", 4)):
            a = (q[:b].contiguous(), kp, vp, table[:b].contiguous(), lens[:b])
            same(f"paged {label} {dname}", [other.paged(*a)],
                 [PK.paged_attention_kernel(*a)], dname)
            row = in_turns({"other": lambda a=a: other.paged(*a),
                            "this": lambda a=a: PK.paged_attention_kernel(*a)},
                           20)
            row.update(in_turns(
                {"serial": lambda a=a: PK._launch(*a, "serial"),
                 **{f"split{n}": lambda a=a, n=n: PK._launch(*a, "split", n)
                    for n in PK.SPLIT_COUNTS}}, 20))
            row["splits"] = PK.splits(b, KVH, npg * page)
            row["bound"] = 2 * dtype.itemsize * b * npg * page * KVH * hd \
                / cs.HBM_BYTES_PER_S * 1e3
            show(f"paged_attention {label} B={b} {dname}", row)
            out[f"{label}_{dname}"] = row
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path, help="root of the other checkout")
    opts = ap.parse_args()
    reason = compat.kernel_unavailable_reason()
    if reason:
        sys.exit(reason)
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    other = Other(opts.root)
    builds = {n: nvcc(SK.SOURCES["ssd_scan"], OUT / f"ssd_cluster{n}.so",
                      f"-DSSD_CB_CLUSTER={n}") for n in CLUSTERS}
    kernels.build()
    other.load()
    clustered = {}
    for n, proc in builds.items():
        finish(f"ssd_scan at clusters of {n}", proc)
        clustered[n] = SK.declare(ctypes.CDLL(str(OUT / f"ssd_cluster{n}.so")))
    record = {"ssd_scan": ssd(other, clustered),
              "paged_attention": paged(other)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    record["card"] = smi
    print(smi)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
