"""The server's --tp and generate(mesh=, weights_int8=True) in a world of 2
gloo processes on the CPU (tf_operator_tpu_torch/serve/server.py's mesh,
models/gpt.py's _generate_on_mesh).

- `python -m tf_operator_tpu_torch.serve --preset tiny --tp 2 --device
  cpu`, two ranks formed from the operator's environment: rank 0 serves
  HTTP and broadcasts each decode call, rank 1 makes the same
  generate(mesh=) call. Greedy chains over HTTP equal one process's
  decode of the same seeded weights up to a bf16 near-tie; sampled and
  beam requests are broadcast and answered too. SIGTERM to rank 0
  drains it, rank 1 stops with it, and both exit 0.
- generate(mesh=, weights_int8=True) at tp = 2 (this file run as a
  script: `_world_main`): the whole model quantized, then laid out, so a
  row-parallel kernel's scales are the whole kernel's. Its greedy chain
  equals the reference's single-device generate(weights_int8=True) on
  the converted weights, and the port's one-process int8 chain, in f32;
  a model already laid out by the plan is gathered whole first.
"""

import copy
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PROMPT = (2, 8)
NEW_TOKENS = 16
LAUNCH_TIMEOUT_S = 240
BOOT_TIMEOUT_S = 120
CHILD_ENV = {"OMP_NUM_THREADS": "1"}
TCFG = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)
# the server's requests: greedy rows of two lengths, a sampled row, beams
ROWS = [[5, 11, 7, 3], [1, 2, 3, 4, 5, 6]]
SAMPLED = {"temperature": 0.8, "top_k": 20, "seed": 3}
BEAMS = 3


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_env(rank: int, port: int) -> dict:
    env = dict(os.environ, **CHILD_ENV)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env.update({
        "TPU_WORKER_ID": str(rank),
        "TPU_WORKER_HOSTNAMES": ",".join(f"worker-{i}" for i in range(WORLD)),
        "JAX_NUM_PROCESSES": str(WORLD),
        "JAX_PROCESS_ID": str(rank),
        "TFJOB_COORDINATOR_OVERRIDE": f"127.0.0.1:{port}",
    })
    return env


def _start_world(argv, logs_dir):
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        log = open(os.path.join(logs_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable] + argv, cwd=REPO,
                                       env=_rank_env(rank, port), stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _finish_world(procs, timeout):
    deadline = time.monotonic() + timeout
    codes = []
    for proc, log in procs:
        try:
            codes.append(proc.wait(timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait())
        finally:
            log.close()
    return codes


def _logs(logs_dir) -> str:
    return "\n".join(open(os.path.join(logs_dir, name)).read()[-3000:]
                     for name in sorted(os.listdir(logs_dir)))


def _world_main(work: str) -> None:
    """generate(mesh=, weights_int8=True) at tp = 2 on this rank; rank 0
    writes out.json under `work`."""
    with distributed.world("cpu"):
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        model = torch_gpt.GPT(TCFG)
        model.load_state_dict(inputs["state"])
        mesh = torch_mesh.build_mesh(torch_mesh.MeshConfig(dp=-1, tp=WORLD), "cpu")
        prompt = torch.as_tensor(inputs["prompt"])
        int8 = torch_gpt.generate(model, prompt, NEW_TOKENS, mesh=mesh, weights_int8=True)
        plain = torch_gpt.generate(model, prompt, NEW_TOKENS, mesh=mesh)
        # a model already laid out by the plan (a tp trainer's) is gathered
        # whole before it is quantized
        laid_out = sharding.apply_tensor_parallel(copy.deepcopy(model), mesh,
                                                  sharding.TRANSFORMER_RULES)
        gathered = torch_gpt.generate(laid_out, prompt, NEW_TOKENS, mesh=mesh,
                                      weights_int8=True)
        if distributed.rank() == 0:
            with open(os.path.join(work, "out.json"), "w") as f:
                json.dump({"int8": int8.tolist(), "plain": plain.tolist(),
                           "int8_laid_out": gathered.tolist(), "tp": mesh.shape["tp"]}, f)


@pytest.fixture(scope="module")
def int8_world(tmp_path_factory):
    """The reference's chains on flax weights, and the world's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt

    jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32)
    params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=PROMPT)
    ref = {
        flag: np.asarray(jax_gpt.generate(jcfg, params, jnp.asarray(prompt), NEW_TOKENS,
                                          weights_int8=flag)).tolist()
        for flag in (True, False)
    }
    work = str(tmp_path_factory.mktemp("tp_int8"))
    state = gpt_state_dict_from_flax(params)
    torch.save({"state": state, "prompt": prompt}, os.path.join(work, "inputs.pt"))
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    codes = _finish_world(_start_world([os.path.abspath(__file__), work], logs),
                          LAUNCH_TIMEOUT_S)
    assert codes == [0] * WORLD, (codes, _logs(logs))
    with open(os.path.join(work, "out.json")) as f:
        out = json.load(f)
    model = torch_gpt.GPT(TCFG)
    model.load_state_dict(state)
    one = torch_gpt.generate(model, torch.as_tensor(prompt), NEW_TOKENS,
                             weights_int8=True).tolist()
    return ref, out, one


def test_tp2_int8_generate_matches_the_reference(int8_world):
    ref, out, one = int8_world
    assert out["tp"] == WORLD
    assert out["int8"] == ref[True]
    assert out["int8"] == one
    assert out["int8_laid_out"] == out["int8"]
    assert out["plain"] == ref[False]


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status


@pytest.fixture(scope="module")
def tp_server(tmp_path_factory):
    """The --tp 2 CLI world: each request's answer over HTTP, then each
    rank's exit code after SIGTERM to rank 0."""
    from tf_operator_tpu_torch.serve.client import DecodeClient

    work = str(tmp_path_factory.mktemp("tp_serve"))
    port = _free_port()
    procs = _start_world(["-m", "tf_operator_tpu_torch.serve", "--preset", "tiny", "--device",
                          "cpu", "--tp", str(WORLD), "--port", str(port), "--host",
                          "127.0.0.1", "--history-interval", "0"], work)
    try:
        deadline = time.monotonic() + BOOT_TIMEOUT_S
        while True:
            try:
                if _get(port, "/readyz") == 200:
                    break
            except OSError:
                pass
            dead = [p.poll() for p, _ in procs if p.poll() is not None]
            assert not dead and time.monotonic() < deadline, _logs(work)
            time.sleep(0.2)
        client = DecodeClient(f"http://127.0.0.1:{port}")
        answers = {
            "greedy": client.generate(ROWS, NEW_TOKENS),
            "sampled": client.generate(ROWS[:1], NEW_TOKENS, **SAMPLED),
            "beams": client.beam_search(ROWS[:1], NEW_TOKENS // 2, num_beams=BEAMS)[0],
        }
    finally:
        procs[0][0].send_signal(signal.SIGTERM)
        codes = _finish_world(procs, LAUNCH_TIMEOUT_S)
    return answers, codes, _logs(work)


def _one_process():
    """The CLI's seeded tiny model and its one-process greedy decode of
    ROWS as the server makes it: one right-padded batch with each row's
    length."""
    from tf_operator_tpu_torch.serve import server as torch_server

    model = torch_server.load_model("tiny", None, torch.device("cpu"))
    width = max(len(row) for row in ROWS)
    prompt = torch.tensor([row + [0] * (width - len(row)) for row in ROWS])
    out = torch_gpt.generate(model, prompt, NEW_TOKENS,
                             prompt_lens=torch.tensor([len(row) for row in ROWS]))
    return model, [out[i, :len(row) + NEW_TOKENS].tolist() for i, row in enumerate(ROWS)]


def test_tp2_server_answers_as_one_process(tp_server):
    """Greedy chains equal the one process's, or first leave them at a
    near-tie: the tiny preset computes in bf16, and tp sums each
    row-parallel layer's partial products (within 2 bf16 ulps of the
    top-2 gap, tests/test_torch_sharded_serve.py's rule). The sampled and
    beam requests, broadcast like any other call, come back whole."""
    from test_torch_sharded_serve import near_tie

    answers, codes, logs = tp_server
    model, want = _one_process()
    for row, got, chain in zip(ROWS, answers["greedy"], want):
        assert got == chain or near_tie(model, chain, got, len(row)), logs
    (sampled,) = answers["sampled"]
    assert sampled[:len(ROWS[0])] == ROWS[0] and len(sampled) == len(ROWS[0]) + NEW_TOKENS
    beams = answers["beams"][0]
    assert len(beams) == BEAMS
    assert all(beam[:len(ROWS[0])] == ROWS[0] for beam in beams)


def test_tp2_sigterm_to_rank0_exits_zero_on_every_rank(tp_server):
    answers, codes, logs = tp_server
    assert codes == [0] * WORLD, logs
    assert "rank 0 stopped; exiting 0" in logs and "drained; exiting 0" in logs


if __name__ == "__main__":
    _world_main(sys.argv[1])
