"""HTTP serving front end for the PyTorch port (the port's form of
scripts/serve.py; imports no jax).

Stdlib-only (http.server) JSON API over ``spatialvla_tpu_torch.serve``'s
engines: the dynamic batcher (``ServingEngine``) or, with ``--split``, the
split-phase engine with a persistent decode batch (``SplitServingEngine``).
Concurrent client requests are batched onto the card by the engine.

Usage:
    python scripts/serve_torch.py (--hf HF_DIR | --serving SERVING_DIR | --ckpt DIR)
        [--bits 8] [--split] [--port 8000] [--max_batch 16] [--device cuda]

``--hf`` loads a reference-format HF checkpoint, ``--ckpt`` one of the
port's own format, both quantized here (``--bits``, ``--vision_bits``,
``--mlp_bits``, ``--kv_bits``, ``--group_size``, ``--depth_res``);
``--serving`` loads a baked serving checkpoint
(``scripts/quantize_checkpoint_torch.py``), whose knobs override those
flags. Runs on the card unless ``--device cpu``; without a card the default
raises. ``--mesh_model N`` / ``--mesh_data N`` shard the policy
(``SpatialVLAPolicy.shard``, every shard on the one device): under a mesh
``--kv_bits`` needs ``--split``, whose engine takes the knob (a serving
checkpoint's baked kv_bits moves to it; the monolithic engine clears it).

API:
    POST /predict   {"image": <nested [H][W][3] uint8 list, or base64
                     PNG/JPEG (needs PIL)>, "instruction": str,
                     "unnorm_key": str|null, "deadline_ms": float|null}
                 -> {"actions": [[...7]...chunk], "action_ids": [...],
                     "latency_ms": float}
                    400 for a base64 image where PIL is missing, 503 when
                    the engine sheds load (--max_queue), 504 past
                    deadline_ms, 500 for any other failure
    GET  /stats  -> the engine's batching and latency counters
    GET  /health -> {"ok": true}
"""
import argparse
import base64
import io
import json
import os
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spatialvla_tpu_torch.serve import EngineOverloaded, RequestExpired  # noqa: E402


class BadRequest(ValueError):
    """A request the server cannot take as sent (HTTP 400)."""


def decode_image(spec) -> np.ndarray:
    if isinstance(spec, str):  # base64-encoded PNG/JPEG
        try:
            from PIL import Image
        except ImportError:
            raise BadRequest("a base64 image needs PIL, which this server lacks: send the "
                             "image as a nested [H][W][3] uint8 list") from None
        img = Image.open(io.BytesIO(base64.b64decode(spec))).convert("RGB")
        return np.asarray(img)
    return np.asarray(spec, dtype=np.uint8)


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, engine.stats())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                image = decode_image(req["image"])
                t0 = time.monotonic()
                out = engine.predict(
                    image, req["instruction"], unnorm_key=req.get("unnorm_key"),
                    deadline_ms=req.get("deadline_ms"),
                )
                self._send(
                    200,
                    {
                        "actions": np.asarray(out["actions"]).tolist(),
                        "action_ids": np.asarray(out["action_ids"]).tolist(),
                        "latency_ms": (time.monotonic() - t0) * 1e3,
                    },
                )
            except BadRequest as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except EngineOverloaded as e:  # shed load: the client should retry
                self._send(503, {"error": f"{type(e).__name__}: {e}"})
            except RequestExpired as e:  # stale frame: send a fresh one
                self._send(504, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - surface the failure to the client
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *args):
            pass  # keep stdout clean for operators

    return Handler


def meshed(args) -> bool:
    return args.mesh_model > 1 or args.mesh_data > 1


def load_policy(args):
    """The policy the flags describe, sharded under ``--mesh_model`` /
    ``--mesh_data``; under a mesh ``args.kv_bits`` is the split engine's."""
    from spatialvla_tpu_torch.inference import SpatialVLAPolicy

    if args.serving:
        policy = SpatialVLAPolicy.load_serving(args.serving, device=args.device)
        if (args.bits != 8 or args.vision_bits != 8 or args.mlp_bits or args.kv_bits
                or args.depth_res or args.group_size):
            print(f"note: the serving checkpoint's baked quantization {policy.quant_desc} "
                  f"(kv_bits={policy.kv_bits}, depth_res={policy.depth_image_size}) overrides "
                  "the --bits/--vision_bits/--mlp_bits/--kv_bits/--depth_res/--group_size "
                  "flags", flush=True)
        if meshed(args) and policy.kv_bits:
            # shard() rejects a policy-level kv_bits (the monolithic mesh
            # decode has no int8-cache layout); the split engine takes it
            baked, policy.kv_bits = policy.kv_bits, None
            if args.split:
                args.kv_bits = args.kv_bits or baked
                print(f"note: baked kv_bits={baked} moves to the split engine (mesh-sharded "
                      "int8 KV runs xla_decode_step)", flush=True)
            else:
                print(f"note: clearing baked kv_bits={baked}: the monolithic mesh decode has "
                      "no int8-cache layout (--split serves it sharded)", flush=True)
    else:
        if meshed(args) and args.kv_bits and not args.split:
            raise SystemExit("--kv_bits under a mesh needs --split (the monolithic mesh decode "
                             "has no int8-cache layout)")
        load = SpatialVLAPolicy.from_hf_checkpoint if args.hf else SpatialVLAPolicy.load
        policy = load(args.hf or args.ckpt, device=args.device)
        if args.bits or args.vision_bits or args.depth_res or args.kv_bits:
            policy.quantize(args.bits or None, vision_bits=args.vision_bits or None,
                            depth_image_size=args.depth_res or None,
                            # under a mesh the split engine owns the kv_bits knob
                            kv_bits=None if meshed(args) else (args.kv_bits or None),
                            mlp_bits=args.mlp_bits or None, group_size=args.group_size or None)
    if meshed(args):
        policy.shard(n_model=args.mesh_model, n_data=args.mesh_data)
    return policy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", metavar="DIR", help="reference-format HF checkpoint")
    src.add_argument("--serving", metavar="DIR", help="serving checkpoint (baked knobs)")
    src.add_argument("--ckpt", metavar="DIR", help="checkpoint of the port's own format")
    ap.add_argument("--bits", type=int, default=8, help="LM weight bits (0 = bf16)")
    ap.add_argument("--vision_bits", type=int, default=8)
    ap.add_argument("--mlp_bits", type=int, default=0,
                    help="4 = int4 MLP under an int8 attention and head")
    ap.add_argument("--kv_bits", type=int, default=0, help="8 = int8 KV cache")
    ap.add_argument("--group_size", type=int, default=0, help="int4 grouped scales")
    ap.add_argument("--depth_res", type=int, default=0, help="reduced ZoeDepth resolution")
    ap.add_argument("--device", default="cuda", help="cuda (raises without a card) or cpu")
    ap.add_argument("--mesh_model", type=int, default=1,
                    help="tensor-parallel serving over N model shards (policy.shard)")
    ap.add_argument("--mesh_data", type=int, default=1,
                    help="data groups a batch's rows split over (policy.shard)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=16,
                    help="monolithic: rows a batch; split: decode slots")
    ap.add_argument("--max_wait_ms", type=float, default=4.0)
    ap.add_argument("--pipeline_depth", type=int, default=3,
                    help="monolithic: batches in flight (1 = synchronous)")
    ap.add_argument("--split", action="store_true",
                    help="split-phase continuous batching (persistent decode slots; needs a "
                         "quantized LM)")
    ap.add_argument("--max_prompt_len", type=int, default=320,
                    help="split: prompt-token capacity of a decode slot")
    ap.add_argument("--decode_block", type=int, default=4,
                    help="split: decode steps a dispatch")
    ap.add_argument("--prefill_min_free", type=int, default=0,
                    help="split: under load, defer prefill until this many slots are free")
    ap.add_argument("--prefill_wait_ms", type=float, default=0,
                    help="split: an idle engine holds its first arrival this long to gather "
                         "a burst")
    ap.add_argument("--prefill_quiet_ms", type=float, default=0,
                    help="split: close the gather window once no arrival lands this long")
    ap.add_argument("--max_queue", type=int, default=0,
                    help="admission bound: requests beyond it get HTTP 503 (0 = unbounded)")
    ap.add_argument("--pad_multiple", type=int, default=16)
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip the start-up warm-up (the first requests then capture the "
                         "decode graphs)")
    ap.add_argument("--gate", default=None, metavar="GATE_JSON",
                    help="quality-gate artifact covering the quality-trade knobs")
    ap.add_argument("--ungated", action="store_true",
                    help="serve quality-trade knobs without a covering gate artifact")
    args = ap.parse_args(argv)

    from spatialvla_tpu_torch.serve import (ServingEngine, SplitServingEngine, enforce_gate,
                                            load_gate, warmup_buckets)

    policy = load_policy(args)
    gate = load_gate(args.gate) if args.gate else policy.quality_gate
    print(enforce_gate(policy, gate, ungated=args.ungated), flush=True)
    warm_instructions = (  # a short and a long instruction: the usual T buckets
        "go",
        "open the top drawer and place the sponge inside of it then close the drawer again",
    )
    s = policy.config.vision.image_size
    sample = np.zeros((s, s, 3), np.uint8)
    if args.split:
        if args.max_prompt_len % args.pad_multiple:
            args.max_prompt_len += args.pad_multiple - args.max_prompt_len % args.pad_multiple
        engine = SplitServingEngine(
            policy, n_slots=args.max_batch, max_prompt_len=args.max_prompt_len,
            prompt_pad_multiple=args.pad_multiple, decode_block=args.decode_block,
            max_queue=args.max_queue or None, prefill_min_free=args.prefill_min_free,
            prefill_wait_ms=args.prefill_wait_ms, prefill_quiet_ms=args.prefill_quiet_ms,
            kv_bits=(args.kv_bits or None) if meshed(args) else None,
        )
        if not args.no_warmup:
            print("warming the split engine's prefill buckets...", flush=True)
            engine.warmup(sample, warm_instructions)
    else:
        buckets = tuple(sorted({b for b in (1, 2, 4, 8, 16) if b < args.max_batch}
                               | {args.max_batch}))
        if not args.no_warmup:
            print("warming the serving buckets (a decode graph per batch and slot bucket)...",
                  flush=True)
            warmup_buckets(policy, sample_image=sample, instructions=warm_instructions,
                           prompt_pad_multiple=args.pad_multiple, batch_buckets=buckets)
        engine = ServingEngine(
            policy, max_batch_size=args.max_batch, max_wait_ms=args.max_wait_ms,
            prompt_pad_multiple=args.pad_multiple, batch_buckets=buckets,
            pipeline_depth=args.pipeline_depth, max_queue=args.max_queue or None,
        )
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(engine))
    print(f"serving on :{args.port} ({'split' if args.split else 'monolithic'}, "
          f"max_batch={args.max_batch}, {policy.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
