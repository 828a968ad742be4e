"""Each of the port's CLIs takes its JAX counterpart's flags: an AST diff of
the two argparse setups (flag names, defaults, types, actions, required,
choices, and the shared crop and dtype helpers; help texts may differ)
finds them identical. The
one departure is the train CLI's --compute_dtype (float32 | bfloat16), the
port's choice of the card's compute type."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"train": {"--compute_dtype"}}
KEYWORDS = ("default", "type", "action", "required", "choices", "nargs")


def _port_clis():
    names = os.listdir(os.path.join(REPO, "pilotguru_tpu_torch", "cli"))
    return sorted(n[:-3] for n in names if n.endswith(".py") and not n.startswith("_"))


def _flags(path):
    with open(path) as f:
        source = f.read()
    flags = {}
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flags[node.args[0].value] = {k.arg: ast.unparse(k.value) for k in node.keywords
                                         if k.arg in KEYWORDS}
    for helper in ("add_crop_args(parser)", "add_dtype_flag(parser)"):
        flags[helper] = helper in source
    return flags


def test_every_jax_cli_is_ported():
    jax = sorted(n[:-3] for n in os.listdir(os.path.join(REPO, "pilotguru_tpu", "cli"))
                 if n.endswith(".py") and not n.startswith("_"))
    assert _port_clis() == jax


@pytest.mark.parametrize("cli", _port_clis())
def test_same_flags_as_the_jax_cli(cli):
    port = _flags(os.path.join(REPO, "pilotguru_tpu_torch", "cli", f"{cli}.py"))
    jax = _flags(os.path.join(REPO, "pilotguru_tpu", "cli", f"{cli}.py"))
    for name in PORT_ONLY.get(cli, ()):
        port.pop(name)
    assert port == jax


@pytest.mark.parametrize("helper", ["add_crop_args", "add_dtype_flag"])
def test_shared_flag_helpers_match(helper):
    def body(path):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == helper:
                return [(n.args[0].value, {k.arg: ast.unparse(k.value) for k in n.keywords
                                           if k.arg in KEYWORDS})
                        for n in ast.walk(node)
                        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"]
        raise AssertionError(f"{helper} not in {path}")

    where = {"add_crop_args": "predict_video.py", "add_dtype_flag": "_common.py"}[helper]
    assert body(os.path.join(REPO, "pilotguru_tpu_torch", "cli", where)) == body(
        os.path.join(REPO, "pilotguru_tpu", "cli", where))
