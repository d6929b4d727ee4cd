"""Per-family continuous-serving front-end wiring (counterpart of
tts_tpu/serving/families.py).

`continuous_server(family, pipe, ...)` adapts a synthesis pipeline to a
`TTSServer` over that family's slot server (serving/continuous*): the JSON
request schema, the submit adapter, and the /stream route where the family
streams over slots. One place for the glue, so every user builds the same
server.

Request bodies (POST /synthesize and /stream):
  kani      {"ids": [[...]]}
  qwen      {"ids": [[...]], "language_id": 0, "speaker_id": null}
  voxcpm    {"ids": [[...]], "prompt_ids": [[...]]?}
  indextts  {"ids": [[...]]} (the reference conditioning fixed at server
             construction; no /stream: BigVGAN is not causal)
  f5        {"gen_text": "...", "speed": 1.0?} (the reference audio and text
             fixed at server construction; no /stream: the DiT denoises
             the whole utterance at once)
"""
from __future__ import annotations

import numpy as np

from .server import TTSServer

__all__ = ["continuous_server", "default_request_body"]


def default_request_body(family: str) -> dict:
    """A minimal valid JSON body for the family (used for warm-up)."""
    return {"gen_text": "hello"} if family == "f5" else {"ids": [[3, 9, 5]]}


def continuous_server(family: str, pipe, *, slots: int = 4,
                      max_tokens: int | None = None, ref=None, ref_audio=None,
                      ref_text: str | None = None, stream_kw: dict | None = None,
                      **slot_kw) -> TTSServer:
    """Build a continuous-batching TTSServer over `pipe` for `family`.

    indextts needs `ref`, the encode_reference(...) tuple; f5 needs
    `ref_audio` (mono int16 or float) and `ref_text`. Extra `slot_kw`
    pass through to the family's slot server (chunk, buckets, max_seq_len,
    queue_limit, ...); `stream_kw` to its submit_stream (window,
    left_context).

    Several cards: pass a LIST of pipelines (one a device, e.g. from
    serving.devices.pipelines_for_devices) and the server routes
    least-loaded across one slot server a pipeline
    (serving/router.SlotRouter).
    """
    skw = stream_kw or {}
    pipes = list(pipe) if isinstance(pipe, (list, tuple)) else [pipe]
    pipe = pipes[0]

    def _route(make_slot):
        servers = [make_slot(p) for p in pipes]
        if len(servers) == 1:
            return servers[0]
        from .router import SlotRouter

        return SlotRouter(servers)

    if family == "kani":
        from .continuous import KaniSlotServer

        slot = _route(lambda p: KaniSlotServer(p, slots=slots, **slot_kw))
        return TTSServer.continuous(
            slot, sample_rate=pipe.codec_cfg.sample_rate,
            submit=lambda ids, deadline_s=None: slot.submit(
                ids, max_new_tokens=max_tokens, deadline_s=deadline_s),
            stream_fn=lambda ids: slot.submit_stream(ids, max_new_tokens=max_tokens, **skw))

    if family == "qwen":
        from .continuous_qwen import QwenSlotServer

        slot = _route(lambda p: QwenSlotServer(p, slots=slots, **slot_kw))

        def from_json(body):
            ids = np.asarray(body["ids"], np.int32)
            prefill, trailing = pipe.build_prefill_embeds(
                ids, int(body.get("language_id", 0)), body.get("speaker_id"))
            return prefill.cpu(), trailing.cpu()

        return TTSServer.continuous(
            slot, sample_rate=pipe.output_sample_rate,
            submit=lambda req, deadline_s=None: slot.submit(
                *req, max_frames=max_tokens, deadline_s=deadline_s),
            request_from_json=from_json,
            stream_fn=lambda req: slot.submit_stream(*req, max_frames=max_tokens, **skw))

    if family == "voxcpm":
        from .continuous_voxcpm import VoxCPMSlotServer

        slot = _route(lambda p: VoxCPMSlotServer(p, slots=slots, **slot_kw))

        def from_json(body):
            ids = np.asarray(body["ids"], np.int32)
            p = (np.asarray(body["prompt_ids"], np.int32)
                 if body.get("prompt_ids") else np.zeros((1, 0), np.int32))
            return p, ids

        return TTSServer.continuous(
            slot, sample_rate=pipe.output_sample_rate,
            submit=lambda req, deadline_s=None: slot.submit(*req, deadline_s=deadline_s),
            request_from_json=from_json,
            stream_fn=lambda req: slot.submit_stream(*req, **skw))

    if family == "indextts":
        from .continuous_indextts import IndexTTSSlotServer

        if ref is None:
            raise ValueError("indextts serving needs ref= (pipe.encode_reference output)")

        def make_slot(p):
            # each server binds the conditioning on ITS pipeline's device
            r = (ref[0].to(p.device), ref[1].to(p.device), [c.to(p.device) for c in ref[2]])
            return IndexTTSSlotServer(p, slots=slots, max_gen=max_tokens, ref=r, **slot_kw)

        slot = _route(make_slot)
        return TTSServer.continuous(
            slot, sample_rate=pipe.sample_rate,
            submit=lambda ids, deadline_s=None: slot.submit(
                ids, max_gen=max_tokens, deadline_s=deadline_s))

    if family == "f5":
        from .continuous_f5 import F5SlotServer

        if ref_audio is None or ref_text is None:
            raise ValueError("f5 serving needs ref_audio= and ref_text=")
        slot = _route(lambda p: F5SlotServer(p, slots=slots, **slot_kw))

        def from_json(body):
            return body["gen_text"], float(body.get("speed", 1.0))

        return TTSServer.continuous(
            slot, sample_rate=pipe.cfg.sample_rate,
            submit=lambda req, deadline_s=None: slot.submit(
                ref_audio, ref_text, req[0], speed=req[1], deadline_s=deadline_s),
            request_from_json=from_json)

    raise ValueError(f"unknown family {family!r}")
