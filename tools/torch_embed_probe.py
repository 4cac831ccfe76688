"""Can this machine's Python be embedded in a C program that imports torch
and reaches the CUDA card?  The question the C API (``nnstpu_capi.h``)
depends on, asked before anything of the port is built.

Prints the running interpreter's embed settings (``Py_ENABLE_SHARED``,
``LIBDIR``, ``LDLIBRARY``), compiles a ten-line C program against it with
``gcc``, runs it with ``PYTHONPATH`` set to this interpreter's path, and
prints how long the embed and ``import torch`` plus one sum on the card
took, then the card's name and power limit.

    python3 tools/torch_embed_probe.py
"""

import os
import subprocess
import sys
import sysconfig
import tempfile

PROGRAM = r"""
#include <Python.h>
#include <stdio.h>
#include <time.h>
static double now(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec + t.tv_nsec * 1e-9;
}
int main(void) {
    double t0 = now();
    Py_InitializeEx(0);
    double t1 = now();
    int rc = PyRun_SimpleString(
        "import sys, torch\n"
        "print('argv', sys.argv, 'prefix', sys.prefix, flush=True)\n"
        "x = torch.ones(4, device='cuda')\n"
        "print('torch', torch.__version__, 'sum on', torch.cuda.get_device_name(0),"
        " float(x.sum()), flush=True)\n");
    double t2 = now();
    printf("rc %d embed %.3f s, import torch and a sum on the card %.3f s\n",
           rc, t1 - t0, t2 - t1);
    return rc;
}
"""


def main():
    keys = ("Py_ENABLE_SHARED", "LIBDIR", "LDLIBRARY", "LDVERSION")
    print("python", sys.version.split()[0], {k: sysconfig.get_config_var(k) for k in keys})
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    with tempfile.TemporaryDirectory() as td:
        src, exe = os.path.join(td, "probe.c"), os.path.join(td, "probe")
        with open(src, "w") as fh:
            fh.write(PROGRAM)
        subprocess.run(["gcc", "-O2", "-o", exe, src, f"-I{sysconfig.get_paths()['include']}",
                        f"-L{libdir}", f"-lpython{ver}", "-ldl", "-lm",
                        f"-Wl,-rpath,{libdir}"], check=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        out = subprocess.run([exe], env=env, capture_output=True, text=True, timeout=300)
        print(out.stdout, out.stderr[-3000:], sep="")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return out.returncode


if __name__ == "__main__":
    sys.exit(main())
