"""Interactive CLI chatbot, the reference's src/main.py.

Counterpart of ``distributed_llm_tpu/serving/cli.py``: a REPL over the
Router; "exit"/"quit" (or end of input) drains both tier engines (the
reference's only clean-shutdown path, src/main.py:16-18), and SIGTERM
drains too (``install_drain_handler``).  ``device`` runs the Router's
tiers and embedder (default: the card)::

    python -m distributed_llm_tpu_torch.serving.cli [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, List, Optional

from ..config import PRODUCTION_CFG
from ..device import DeviceLike
from .router import Router


class Chatbot:
    def __init__(self, strategy: str = "semantic",
                 config: Optional[Dict[str, Any]] = None,
                 router: Optional[Router] = None,
                 device: DeviceLike = None):
        self.router = router or Router(strategy=strategy, config=config,
                                       device=device)
        self.history: List[Dict[str, str]] = []

    def add_message(self, role: str, content: str) -> None:
        self.history.append({"role": role, "content": content})

    def ask(self, text: str) -> str:
        """One turn: append, route, record the reply."""
        self.add_message("user", text)
        response, _tokens, device = self.router.route_query(self.history)
        reply = (response.get("response", "") if isinstance(response, dict)
                 else str(response))
        self.add_message("assistant", reply)
        return f"[{device}] {reply}"

    def shutdown(self, graceful: bool = True) -> None:
        """Stop both tier engines.  ``graceful`` drains first (stop
        admitting, finish in-flight work under drain_timeout_s), the path
        of SIGTERM and of the REPL's exit; False stops at once."""
        if graceful:
            self.router.drain()
            return
        self.router.nano.server_manager.stop_server()
        self.router.orin.server_manager.stop_server()

    def chat(self) -> None:
        print("Chatbot ready — type 'exit' or 'quit' to stop.")
        while True:
            try:
                text = input("> ").strip()
            except (EOFError, KeyboardInterrupt):
                text = "exit"
            if text.lower() in ("exit", "quit"):
                self.shutdown()
                print("Tier engines stopped. Bye.")
                return
            if text:
                print(self.ask(text), flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="the routed chatbot REPL")
    p.add_argument("--device", default=None,
                   help="cpu runs the plain PyTorch path (default: the card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    bot = Chatbot(strategy="semantic", config=dict(PRODUCTION_CFG),
                  device=args.device)
    # SIGTERM mid-conversation drains in-flight work before exit, the
    # API server's contract (serving/app.py install_drain_handler).
    from .app import install_drain_handler
    install_drain_handler(bot.router)
    bot.chat()


if __name__ == "__main__":
    main()
