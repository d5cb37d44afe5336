"""The port covers the reference: every module of cldrd_tpu/ has a
counterpart of the same path in cldrd_tpu_torch/ (models/hf_loader.py's
conversions live in models/convert.py), and every flag of every
reference CLI parses in the port's CLI of the same name, with at least
the reference's choices."""
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# reference modules whose work the port keeps under another name
ELSEWHERE = {"models/hf_loader.py": "models/convert.py"}
CLIS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "cldrd_tpu",
                                                      "cli"))
              if f.endswith(".py") and f not in ("__init__.py", "common.py"))


def test_every_reference_module_has_a_counterpart():
    missing = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "cldrd_tpu")):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name),
                                  os.path.join(ROOT, "cldrd_tpu"))
            port = os.path.join(ROOT, "cldrd_tpu_torch",
                                ELSEWHERE.get(rel, rel))
            if not os.path.exists(port):
                missing.append(rel)
    assert not missing, missing


@pytest.mark.parametrize("name", CLIS)
def test_every_reference_flag_parses_in_the_port(name):
    ref = importlib.import_module(f"cldrd_tpu.cli.{name}").build_parser()
    port = importlib.import_module(
        f"cldrd_tpu_torch.cli.{name}").build_parser()
    ours = port._option_string_actions
    missing = sorted(set(ref._option_string_actions) - set(ours))
    assert not missing, missing
    for flag, action in ref._option_string_actions.items():
        if action.choices:
            assert set(action.choices) <= set(ours[flag].choices or ()), flag
