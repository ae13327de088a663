"""Compile one CUDA source of two checkouts for sm_90a and compare the SASS
of their kernels, kernel by kernel.

    python tools/sass_diff.py <old checkout> <new checkout> \
        stylemesh_tpu_torch/kernels/csrc/sample.cu

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit on the machine with the
card). Each source is compiled with the same flags into a cubin in a
temporary directory. A kernel of the new build stands for the old kernel
of the same name and template arguments, or for the old kernel whose
template arguments are its own less trailing ``false`` ones (a bool
template parameter added at the end, as ``gather_kernel``'s ``EACH``, at
its old behaviour).
Prints, per old kernel, the instruction counts of both and whether the
instructions are identical (addresses and encodings aside); exits 1 when
an old kernel has no counterpart or differs.
"""

import re
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
TEMPLATE = re.compile(r"^(_Z\d+\w+?)I((?:L\w+?E)+)E(.*)$")


def sass(source, out_dir, tag):
    cubin = Path(out_dir) / f"{tag}.cubin"
    subprocess.run(["nvcc", *FLAGS, "-cubin", "-o", str(cubin), str(source)],
                   check=True)
    dump = subprocess.run(["cuobjdump", "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            kernels[name].append(m.group(1))
    return kernels


def counterpart(name, new):
    """The new kernel standing for the old kernel ``name``."""
    if name in new:
        return name
    m = TEMPLATE.match(name)
    if not m:
        return None
    for extra in range(1, 4):
        twin = f"{m.group(1)}I{m.group(2)}{'Lb0E' * extra}E{m.group(3)}"
        if twin in new:
            return twin
    return None


def main(old_root, new_root, source):
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(Path(old_root) / source, tmp, "old")
        new = sass(Path(new_root) / source, tmp, "new")
    ok = True
    for name, ins in sorted(old.items()):
        twin = counterpart(name, new)
        same = twin is not None and new[twin] == ins
        ok &= same
        print(f"{name} -> {twin}: {len(ins)} vs "
              f"{len(new[twin]) if twin else '-'} instructions, "
              f"{'identical' if same else 'DIFFERENT'}")
    for name in sorted(set(new) - {counterpart(n, new) for n in old}):
        print(f"new kernel {name}: {len(new[name])} instructions")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
