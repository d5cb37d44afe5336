"""A cell joins the benchmark by new files and appended entries alone.

In a copy of ``portbench/`` and ``BENCHMARK.json``, a cell is added the
way a later change adds one: a configuration file (a copy of MiniLM's
under a new name), a traffic mix naming the teacher's driver, its
limits, its tiny sizes and a new per-layer reader of the port's spans,
each a new file; and entries appended to ``BENCHMARK.json``'s lists,
with an end-to-end metric of its own (``teacher_pass_device_ms.<cell>``). The
CPU rehearsal of the new cell and the check that every name has its
files then pass in the copy, and no file that was there before changed.
"""
import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

NEW = "minilm-copy.teacher.flat-top100"
CONFIG = "minilm-l6-copy"
TRAFFIC = "teacher-copy"
READER = '''"""Host milliseconds a teacher score call takes, from the port's
``cldrd.teacher.score`` spans over the window."""
from portbench.metrics import span_call_ms


def read(m):
    return span_call_ms(m, "cldrd.teacher.score")
'''


def _digests(root: str) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(root: str, rel: str, obj) -> None:
    path = os.path.join(root, rel)
    assert not os.path.exists(path), f"{rel} exists: not a new file"
    with open(path, "w", encoding="utf-8") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj, indent=1))


def _add_cell(root: str) -> None:
    here = os.path.join(root, "portbench")
    bench = harness.load_json(root, "BENCHMARK.json")
    teacher = next(w for w in bench["workloads"]
                   if w["config"] == "minilm-l6-teacher")
    old_conf = next(c for c in bench["configs"]
                    if c["name"] == teacher["config"])
    config = harness.load_json(root, old_conf["file"])
    config["name"] = CONFIG
    _write(root, f"portbench/configs/{CONFIG}.json", config)
    traffic = harness.load_json(here, "traffic", teacher["traffic"] + ".json")
    assert traffic["driver"] == "teacher"
    _write(root, f"portbench/traffic/{TRAFFIC}.json", traffic)
    _write(root, f"portbench/limits/{NEW}.json",
           harness.load_json(here, "limits", teacher["name"] + ".json"))
    _write(root, f"portbench/tiny/{NEW}.json",
           harness.load_json(here, "tiny", teacher["name"] + ".json"))
    _write(root, "portbench/metrics/score_call_ms.py", READER)

    grown = copy.deepcopy(bench)
    grown["configs"].append(dict(old_conf, name=CONFIG,
                                 file=f"portbench/configs/{CONFIG}.json"))
    grown["workloads"].append(dict(teacher, name=NEW, config=CONFIG,
                                   traffic=TRAFFIC))
    grown["end_to_end"].append({
        "name": "teacher_pass_device_ms.copy", "unit": "ms",
        "better": "lower", "bound": 0.01, "source": "device_trace",
        "workloads": [NEW]})
    for name, unit, better in (("mfu_pct.copy", "%", "higher"),
                               ("score_call_ms.copy", "ms", "lower")):
        grown["per_layer"].append({
            "name": name, "unit": unit, "better": better,
            "source": "host_clock", "layer": "whole call (copy)",
            "moves": "teacher_pass_device_ms.copy", "workloads": [NEW]})
    # appended entries only: every list keeps what it held, in order
    for key, value in bench.items():
        if isinstance(value, list):
            assert grown[key][:len(value)] == value
        else:
            assert grown[key] == value
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(grown, f, indent=1)


def test_a_cell_joins_by_new_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    _add_cell(root)
    tests = "portbench/tests/test_portbench_traffic.py"
    ids = [f"{tests}::test_rehearsal[untraced-{NEW}]",
           f"{tests}::test_rehearsal[traced-{NEW}]",
           f"{tests}::test_every_name_has_its_files"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, harness.ROOT, os.environ.get("PYTHONPATH", "")]))
    done = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", *ids],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    out = done.stdout + done.stderr
    assert done.returncode == 0 and "3 passed" in out, out[-4000:]
    after = _digests(root)
    changed = [rel for rel, digest in before.items()
               if rel != "BENCHMARK.json" and after.get(rel) != digest]
    assert not changed, changed
    assert set(after) - set(before) >= {
        f"portbench/configs/{CONFIG}.json", f"portbench/tiny/{NEW}.json",
        f"portbench/traffic/{TRAFFIC}.json", f"portbench/limits/{NEW}.json",
        "portbench/metrics/score_call_ms.py"}
