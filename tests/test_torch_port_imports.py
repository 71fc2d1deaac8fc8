"""The PyTorch port stands alone: importing every module of it, and
chip_smoke.py, loads no jax, nothing of the JAX package and no pandas; and
no source file of the port imports them, even inside a function."""

import ast
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "seq2seq_abcd_vae_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "seq2seq_abcd_vae_tpu", "pandas")


def _port_modules():
    for dirpath, _, files in os.walk(PORT):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
                yield rel[:-3].replace(os.sep, ".").removesuffix(".__init__")


def test_importing_the_port_loads_no_jax_and_no_pandas():
    modules = list(_port_modules()) + ["chip_smoke"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print(sorted(m for m in sys.modules "
              f"if m.split('.')[0] in {FORBIDDEN!r}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(modules) > 20
    assert {"seq2seq_abcd_vae_tpu_torch.utils.backend_select",
            "seq2seq_abcd_vae_tpu_torch.utils.sync",
            "seq2seq_abcd_vae_tpu_torch.ops.probe_kernel"} <= set(modules)


def test_no_source_file_imports_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
