"""Serving: the paged KV pool and the continuous-batching engine.

The HTTP tier of the reference (``coalesce``, ``qos``, ``signing``,
``service``) is not ported yet (ROADMAP Queue 1 item 6).
"""
from repro_torch.serving.pages import PagePool, PagePoolConfig  # noqa: F401
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
