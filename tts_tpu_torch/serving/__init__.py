"""Serving layer: request batching over the synthesis pipelines, and a
dependency-free HTTP front-end (counterpart of tts_tpu/serving).

Two batching modes:

  * `MicroBatcher`: admission-time grouping. Requests that arrive together
    share one batched decode; a request arriving mid-decode waits for the
    whole batch, so queueing dominates p99 at production rates.
  * slot servers (`serving/slots.SlotEngine` adapters: `KaniSlotServer`,
    `QwenSlotServer`, `IndexTTSSlotServer`, `VoxCPMSlotServer`,
    `F5SlotServer`): CONTINUOUS batching. A fixed batch of slots decodes
    in chunks of steps with no host read inside; between chunks finished
    rows resolve and queued requests are prefilled in place into free rows
    (at the shared kv position of the AR families; F5's rows each at their
    own NFE step).

`SlotRouter` spreads requests over one slot server a card
(`pipelines_for_devices`); `continuous_server` wires a family's slot
server, request schema and streaming route behind `serve_http`.
"""
from .batcher import BatchStats, MicroBatcher
from .continuous import KaniSlotServer
from .devices import pipeline_device, pipelines_for_devices, replicate_pipeline
from .router import SlotRouter
from .server import TTSServer, serve_http
from .slots import SlotEngine, SlotStats, StreamHandle

__all__ = ["MicroBatcher", "BatchStats", "TTSServer", "serve_http",
           "SlotEngine", "SlotStats", "StreamHandle", "SlotRouter",
           "KaniSlotServer", "QwenSlotServer", "IndexTTSSlotServer",
           "VoxCPMSlotServer", "F5SlotServer", "continuous_server",
           "default_request_body", "replicate_pipeline", "pipelines_for_devices",
           "pipeline_device"]

_LAZY = {
    "QwenSlotServer": "continuous_qwen",
    "IndexTTSSlotServer": "continuous_indextts",
    "VoxCPMSlotServer": "continuous_voxcpm",
    "F5SlotServer": "continuous_f5",
    "continuous_server": "families",
    "default_request_body": "families",
}


def __getattr__(name):
    # lazy: the family adapters pull in their model stacks
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(name)
