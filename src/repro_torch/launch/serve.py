"""Serving launcher: batched prefill + decode loop for every architecture.

Counterpart of ``repro/launch/serve.py``: a prefill step over the prompt
batch and an autoregressive greedy decode loop against the cache (a
ring-buffer KV cache for the decoders, a latent one for MLA, a recurrent
state for RWKV-6, both for Jamba: K/V in its attention layers, conv and SSM
states in its Mamba layers; Whisper's self-attention ring buffer beside its
cross-attention K/V), under ``torch.inference_mode()``.  A VLM's prefix
embeddings and Whisper's frames go to the prefill with the prompt; the
prefix counts in the cache position of every decode step.  Reports prefill
and per-token decode latency and throughput (host clock around work that
ends in a device synchronise).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --prompt-len 4096 --gen 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b --smoke \
      --prompt-len 64 --gen 16 --batch 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --smoke \
      --prompt-len 32 --gen 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --layers 8 \
      --prompt-len 4096 --gen 32 --batch 4

Like the trainer it runs on ``--device cuda`` (the default) and raises when
CUDA is not available; ``--layers`` cuts the depth (Jamba: to a whole number
of 8-layer super-blocks; an MoE decoder: to more than its leading dense
layers) and ``--use-pallas never``
takes the plain versions of every hand-written kernel.  One difference from
the reference on purpose: JAX always builds its prompts from a 64-token
sample, so a longer ``--prompt-len`` is silently cut to 64 there; here the
sample is ``max(prompt_len, 64)`` tokens long, which gives the same tokens
as JAX for prompts of up to 64 and the asked-for length beyond.

``--serve`` wraps the generate step in a stdlib HTTP front end:
``GET /healthz`` is the readiness probe, ``POST /run`` executes one request
under a per-request wall-clock budget (504 on expiry), and SIGTERM
triggers a graceful drain: the probe flips to 503, in-flight requests
finish, then the listener exits.
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from repro_torch.configs import INPUT_SHAPES, InputShape
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.train import config_from_args, resolve_device
from repro_torch.models.registry import get_model, pad_cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, B: int, P: int, seed: int, device) -> dict:
    """The prefill's batch on ``device``: ``B`` prompts of ``P`` tokens and
    the model's frontend stubs (a VLM's ``prefix_embeds``, Whisper's
    ``frames``), drawn as the reference's launcher draws them."""
    base = INPUT_SHAPES["prefill_32k"].smoke()
    shape = InputShape(base.name, max(P, base.seq_len), base.global_batch, base.kind)
    raw = SyntheticLM(cfg, shape, seed=seed).batch(0, batch_size=B)
    batch = {"tokens": torch.from_numpy(raw["tokens"][:, :P]).to(device)}
    for key in ("prefix_embeds", "frames"):
        if key in raw:
            batch[key] = torch.from_numpy(raw[key]).to(device)
    return batch


def run(args, params=None) -> dict:
    """Prefill ``--batch`` prompts of ``--prompt-len`` tokens, then decode
    ``--gen`` tokens greedily.  ``params`` (the model's tree on the device)
    replaces the random ones drawn from ``--seed``.  The result holds the
    timings, the generated tokens (B, gen + 1) and the prefill's next-token
    logits (B, V) as float32 on the host."""
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    api = get_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen

    if params is None:
        params = api.init(torch.Generator(device=device).manual_seed(args.seed))
    batch = prompt_batch(cfg, B, P, args.seed, device)
    # cache entries written by the prefill: the prompt (and a VLM's prefix)
    n_cached = P + (cfg.prefix_embeds if cfg.family == "vlm" else 0)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, batch)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        cache = pad_cache(cache, n_cached + G)   # headroom for generated tokens

        tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        generated = [tokens]
        t0 = time.perf_counter()
        for i in range(G):
            step_logits, cache = api.decode_step(params, {"tokens": tokens}, cache,
                                                 n_cached + i)
            tokens = torch.argmax(step_logits[:, -1:], dim=-1).to(torch.int32)
            generated.append(tokens)
        _sync(device)
        t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1).cpu()
    assert not bool((out < 0).any()) and not bool((out >= cfg.padded_vocab).any())
    result = {
        "arch": cfg.name, "batch": B, "prompt_len": P, "generated": G,
        "prefill_s": t_prefill,
        "decode_tok_per_s": B * G / t_decode if G else 0.0,
        "decode_ms_per_token": t_decode / G * 1e3 if G else 0.0,
        "device": str(device), "num_layers": cfg.num_layers,
        "tokens": out.numpy(),
        "prefill_logits": logits[:, -1].float().cpu().numpy(),
    }
    print(f"[serve] {cfg.name}: prefill({B}x{P}) {t_prefill*1e3:.0f} ms, "
          f"decode {result['decode_ms_per_token']:.1f} ms/tok "
          f"({result['decode_tok_per_s']:.0f} tok/s)")
    return result


# ---------------------------------------------------------------------------
# HTTP front end: readiness probe, per-request timeout, graceful drain
# ---------------------------------------------------------------------------

class ServeFrontend:
    """stdlib HTTP wrapper around a request handler callable.

    ``handler(payload: dict) -> dict`` runs on a worker thread per
    request; a request that blows ``request_timeout`` seconds gets a 504
    (the worker is abandoned to finish in the background: stdlib threads
    cannot be recalled, which is exactly why the probe exists).  Routes:

    - ``GET /healthz``  -> 200 ``{"status": "ok"}`` while serving,
      503 ``{"status": "draining"}`` once a drain began (load balancers
      stop routing here *before* the listener dies);
    - ``POST /run``     -> the handler's JSON result; 503 while
      draining, 504 on timeout, 500 on handler exceptions.

    :meth:`drain` is the graceful shutdown: flip the probe, wait up to
    ``grace`` seconds for in-flight requests, stop the listener.
    """

    def __init__(self, handler, *, request_timeout: float = 30.0,
                 host: str = "127.0.0.1", port: int = 0,
                 grace: float = 10.0):
        self.handler = handler
        self.request_timeout = request_timeout
        self.grace = grace
        self.draining = threading.Event()
        self._inflight = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def _make_handler(self):
        front = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: the probe polls
                pass

            def _reply(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path != "/healthz":
                    return self._reply(404, {"error": "unknown route"})
                if front.draining.is_set():
                    return self._reply(503, {"status": "draining"})
                return self._reply(200, {"status": "ok"})

            def do_POST(self):
                if self.path != "/run":
                    return self._reply(404, {"error": "unknown route"})
                if front.draining.is_set():
                    return self._reply(503, {"status": "draining"})
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError as e:
                    return self._reply(400, {"error": f"bad json: {e}"})
                with front._lock:
                    front._inflight += 1
                try:
                    box: dict = {}

                    def work():
                        try:
                            box["result"] = front.handler(payload)
                        except Exception as e:  # noqa: BLE001
                            box["error"] = f"{type(e).__name__}: {e}"

                    t = threading.Thread(target=work, daemon=True)
                    t.start()
                    t.join(front.request_timeout)
                    if t.is_alive():
                        return self._reply(504, {
                            "error": f"request exceeded "
                                     f"{front.request_timeout}s"})
                    if "error" in box:
                        return self._reply(500, {"error": box["error"]})
                    return self._reply(200, box["result"])
                finally:
                    with front._idle:
                        front._inflight -= 1
                        front._idle.notify_all()

        return Handler

    def serve_forever(self):
        self.httpd.serve_forever(poll_interval=0.1)

    def drain(self):
        """Graceful shutdown: refuse new work, wait for in-flight
        requests (bounded by ``grace``), stop the listener."""
        self.draining.set()
        deadline = time.monotonic() + self.grace
        with self._idle:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._idle.wait(left)
        self.httpd.shutdown()
        self.httpd.server_close()  # refuse, don't hang, new connections

    def install_sigterm(self):
        signal.signal(signal.SIGTERM,
                      lambda *_: threading.Thread(target=self.drain,
                                                  daemon=True).start())


def serve(args) -> None:
    """Blocking HTTP mode: each POST /run re-runs the generate step with
    per-request overrides for the small knobs (batch/prompt_len/gen)."""

    def handle(payload: dict) -> dict:
        ns = argparse.Namespace(**vars(args))
        for k in ("batch", "prompt_len", "gen"):
            if k in payload:
                setattr(ns, k, int(payload[k]))
        result = run(ns)
        result["tokens"] = result["tokens"].tolist()
        del result["prefill_logits"]          # B x vocab floats: not for the wire
        return result

    front = ServeFrontend(handle, request_timeout=args.request_timeout,
                          port=args.port, grace=args.grace)
    front.install_sigterm()
    print(f"[serve] listening on :{front.port} "
          f"(healthz probe, {args.request_timeout}s/request)")
    front.serve_forever()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    help="any registered architecture (repro_torch.configs.archs.ALL_ARCHS)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve", action="store_true",
                    help="HTTP mode: /healthz probe + /run endpoint")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (0 = ephemeral)")
    ap.add_argument("--request-timeout", type=float, default=30.0,
                    dest="request_timeout",
                    help="per-request wall-clock budget (504 past it)")
    ap.add_argument("--grace", type=float, default=10.0,
                    help="drain budget on SIGTERM before the listener stops")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is none) or cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's; "
                         "jamba-v0.1-52b: a multiple of 8; MoE: more than moe.first_dense)")
    ap.add_argument("--use-pallas", default="", choices=["", "auto", "always", "never"],
                    help="hand-written kernels: auto = on CUDA tensors; never = "
                         "plain versions everywhere (reference runs)")
    return ap


def main(argv=None, params=None):
    """``params``: the model's tree on the device, in place of the random
    ones drawn from ``--seed`` (not with ``--serve``)."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)             # refuse before a listener starts, too
    if args.serve:
        return serve(args)
    return run(args, params)


if __name__ == "__main__":
    main()
