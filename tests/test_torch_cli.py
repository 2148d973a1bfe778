"""The port's REPL (``serving/cli.py``) and ``python -m
distributed_llm_tpu_torch``, against the JAX package's.

- The twins of ``tests/test_cli.py``: ``ask`` and ``shutdown`` over the
  tiny tiers, and the REPL loop, which skips empty input and drains both
  tiers on ``exit``.
- The REPL's replies equal the JAX ``Chatbot``'s, turn for turn (device
  and text), on the trained tiny tiers at float32 copies of the presets,
  as the checkpoint parity tests run them (in bf16 the two packages' CPU
  math rounds at different points).
- ``python -m distributed_llm_tpu_torch.serving.cli --device cpu`` takes
  scripted turns on stdin, drains and exits 0 at ``exit``;
  ``python -m distributed_llm_tpu_torch --device cpu --port P`` answers
  ``/health`` and ``/chat`` and drains on SIGTERM, exiting 0.
"""

from __future__ import annotations

import builtins
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.serving.cli import Chatbot as JaxChatbot
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.config import ClusterConfig, tiny_cluster
from distributed_llm_tpu_torch.serving.cli import Chatbot
from distributed_llm_tpu_torch.serving.router import Router

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ["hello there",
         "explain how rivers form deltas near the sea, in detail please",
         "and what happens at the coast?"]


def _router():
    tiny = tiny_cluster()
    return Router(strategy="heuristic", benchmark_mode=True, device="cpu",
                  cluster=ClusterConfig(nano=tiny.nano, orin=tiny.orin))


def test_cli_ask_and_shutdown():
    bot = Chatbot(router=_router())
    out = bot.ask("hello there")
    assert out.startswith("[nano]") or out.startswith("[orin]")
    assert [m["role"] for m in bot.history] == ["user", "assistant"]
    bot.shutdown()
    assert not bot.router.nano.server_manager.is_server_running()
    assert not bot.router.orin.server_manager.is_server_running()


def test_cli_immediate_shutdown_stops_both_tiers():
    bot = Chatbot(router=_router())
    bot.ask("hi")
    bot.shutdown(graceful=False)
    assert not bot.router.nano.server_manager.is_server_running()
    assert not bot.router.orin.server_manager.is_server_running()


def test_cli_repl_loop_exits_cleanly(monkeypatch, capsys):
    bot = Chatbot(router=_router())
    lines = iter(["hi", "", "exit"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(lines))
    bot.chat()
    out = capsys.readouterr().out
    assert "Tier engines stopped" in out
    assert len(bot.history) == 2           # empty input routed nothing
    assert not bot.router.nano.server_manager.is_server_running()


@pytest.fixture
def float32_presets(monkeypatch):
    for table in (jax_config.MODEL_PRESETS, torch_config.MODEL_PRESETS):
        for name in ("nano_test", "orin_test"):
            monkeypatch.setitem(table, name, dataclasses.replace(
                table[name], dtype="float32"))


def test_repl_replies_equal_jax_on_the_trained_tiers(float32_presets):
    cfg = dict(torch_config.BENCHMARK_CFG)
    bots = {"jax": JaxChatbot(strategy="heuristic",
                              config=dict(jax_config.BENCHMARK_CFG)),
            "torch": Chatbot(strategy="heuristic", config=cfg,
                             device="cpu")}
    replies = {}
    try:
        for who, bot in bots.items():
            assert all(t.tier.checkpoint_path
                       for t in bot.router.tiers.values())
            replies[who] = [bot.ask(text) for text in TURNS]
    finally:
        for bot in bots.values():
            bot.shutdown()
    assert replies["torch"] == replies["jax"]
    assert {r.split("]")[0] for r in replies["torch"]} <= {"[nano", "[orin"}
    assert [m["role"] for m in bots["torch"].history] == \
        ["user", "assistant"] * len(TURNS)


def test_python_m_cli_drains_and_exits_on_exit():
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_llm_tpu_torch.serving.cli",
         "--device", "cpu"], cwd=REPO, input="hello there\n\nwhat is 2+2?\n"
        "exit\n", capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("Chatbot ready")
    # input() prompts with "> " on the reply's line: the empty turn adds
    # one more prompt and no reply.
    turns = [ln for ln in lines if "[nano] " in ln or "[orin] " in ln]
    assert len(turns) == 2, proc.stdout
    assert lines[-1].endswith("Tier engines stopped. Bye.")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_package_serves_chat_and_drains_on_sigterm():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_tpu_torch", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 180
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.3)
        assert health is not None, proc.stderr.read() if proc.poll() else ""
        req = urllib.request.Request(
            base + "/chat", data=json.dumps(
                {"message": "hello there", "session_id": "m"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["device"] in ("nano", "orin") and body["reply"]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert f"API running on http://127.0.0.1:{port}" in out
    assert "draining" in err
