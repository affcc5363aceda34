"""Build the CUDA kernels and report what ptxas says of them.

    python -m nsgp_tpu_torch.tools.ptxas_report [bs ...]

Prints the build's wall time, the card's name and power limit, and for each
kernel at the given block sizes (default: 4, the matern32/matern52 models)
and both dtypes its registers, spill bytes and stack frame, read from the
build log (``-Xptxas -v``).  Needs nvcc; the numbers are the compiler's, not
measurements of the card.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time

from nsgp_tpu_torch.ops import _build

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_KERNEL = re.compile(r"((?:fused_adf_vjp|fused_adf_mb|fused_adf|fused_ihgp_adf_vjp|fused_ihgp_adf"
                     r"|fused_ihgp_smooth"
                     r"|(?:fwd|bwd)_(?:totals|carry|emit))_kernel)"
                     r"I([fd])Li(\d+)E")


def parse(log: str) -> list:
    """[(kernel, dtype, bs, registers, stack, spill_stores, spill_loads)]."""
    rows, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            k = _KERNEL.search(m.group(1))
            cur = [k.group(1), "f32" if k.group(2) == "f" else "f64", int(k.group(3)),
                   None, None, None, None] if k else None
        elif cur and "bytes stack frame" in line:
            cur[4:7] = [int(x) for x in re.findall(r"(\d+) bytes", line)]
        elif cur and "Used" in line and "registers" in line:
            cur[3] = int(re.search(r"Used (\d+) registers", line).group(1))
            rows.append(tuple(cur))
            cur = None
    return rows


def main(argv) -> int:
    sizes = [int(a) for a in argv] or [4]
    lib = _build.library_path()
    if lib.exists():
        lib.unlink()
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(_build.SOURCES)} sources in "
          f"parallel, then the link)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print("card:", smi.stdout.strip() or "none")
    rows = parse(_build.ptxas_log_path(lib).read_text())
    print(f"{len(rows)} kernel instantiations; worst registers "
          f"{max(r[3] for r in rows)}, worst spill stores {max(r[5] for r in rows)} B")
    print("kernel dtype bs registers stack_B spill_store_B spill_load_B")
    for r in sorted(rows):
        if r[2] in sizes:
            print(*r)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
