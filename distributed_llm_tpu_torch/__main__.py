"""``python -m distributed_llm_tpu_torch``: serve the chat API.

Counterpart of ``distributed_llm_tpu/__main__.py``: the Flask app
(``serving/app.py``) with the reference's ``/chat``, ``/history``,
``/stats`` and ``/ui`` surface on port 8000 (reference: ``python
src/app.py``), on the card; ``--port`` and ``--device cpu`` as
``serving.app.main`` takes them.
"""

from .serving.app import main

if __name__ == "__main__":
    main()
