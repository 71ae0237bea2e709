"""Registers, spills and SASS of each kernel of this checkout's CUDA
sources against another checkout's, kernel by kernel.

    python3 -m msmp_pde_torch.tools.sass_diff <other checkout> [source ...]

Compiles ``msmp_pde_torch/csrc/<source>.cu`` of both checkouts (default:
lem_fwd and lem_bwd) with the port's nvcc flags into a temporary
directory, and for every kernel the other checkout has prints whether its
ptxas resources and its SASS (``cuobjdump -sass``, addresses stripped)
are unchanged, and lists the kernels only this checkout has. Needs nvcc,
not a card.
"""
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from msmp_pde_torch.ops import _build


def compile_report(src: Path, lib: Path) -> str:
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stdout}"
                           f"{out.stderr}")
    return out.stdout + out.stderr


def sass(lib: Path) -> dict:
    """{kernel: [instructions]} of a library, addresses stripped."""
    nvcc = Path(_build._nvcc())
    text = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            funcs[cur].append(re.sub(r"/\*[0-9a-f]{4}\*/", "",
                                     line.split(";")[0]).strip())
    return dict(zip(_build.demangle(list(funcs)), funcs.values()))


def main(argv):
    other = Path(argv[0]) / "msmp_pde_torch" / "csrc"
    names = argv[1:] or ["lem_fwd", "lem_bwd"]
    with tempfile.TemporaryDirectory() as tmp:
        for n in names:
            libs = [Path(tmp) / f"{side}_{n}.so" for side in ("a", "b")]
            reps = [compile_report(other / f"{n}.cu", libs[0]),
                    compile_report(_build.CSRC / f"{n}.cu", libs[1])]
            ra, rb = (dict(_build.resources(r)) for r in reps)
            sa, sb = sass(libs[0]), sass(libs[1])
            for k in sorted(ra):
                print(f"{n}: {k}: resources "
                      f"{'unchanged' if ra[k] == rb.get(k) else 'CHANGED'} "
                      f"({'; '.join(rb.get(k, ['gone']))}); SASS "
                      f"{'identical' if sa.get(k) == sb.get(k) else 'DIFFERS'}"
                      f" ({len(sa.get(k, []))} instructions)")
            for k in sorted(set(rb) - set(ra)):
                print(f"{n}: {k} (only here): {'; '.join(rb[k])}")


if __name__ == "__main__":
    main(sys.argv[1:])
