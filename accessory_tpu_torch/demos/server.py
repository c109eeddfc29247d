"""HTTP serving demo of the port (stdlib only).

Endpoints:
  POST /generate        {"prompts": [...], "max_gen_len", "temperature",
                         "top_p", "stop"} -> {"outputs": [...]}
  POST /chat            {"qas": [[q, a], ..., [q, null]]} -> {"response": ...}
  POST /stream_generate {"prompt": ...} -> text/event-stream of {"text", ...}
  GET  /health          -> {"status": "ok"}
  GET  /                -> a single-page chat UI

Port of ``accessory_tpu/demos/server.py`` (BatchedEngine, make_handler,
serve, main). With ``--continuous`` the ``/generate`` route goes through a
``ContinuousBatcher`` on a background thread, so concurrent requests batch
onto the card; the other routes call the model's ``generate`` /
``stream_generate`` under a lock.

    python -m accessory_tpu_torch.demos.server --pretrained_path DIR --quant --continuous
"""

from __future__ import annotations

import argparse
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def get_args_parser():
    p = argparse.ArgumentParser("serving demo", add_help=False)
    p.add_argument("--pretrained_path", required=True, type=str)
    p.add_argument("--llama_type", default=None, type=str)
    p.add_argument("--max_seq_len", default=2048, type=int)
    p.add_argument("--quant", action="store_true")
    p.add_argument("--quant_bits", default=4, type=int, choices=(4,),
                   help="the port serves W4 (W3 / W8 are not ported)")
    p.add_argument("--kv_dtype", default=None, choices=(None, "int8"),
                   help="int8: quantized KV cache (2x context per GB)")
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8080, type=int)
    # continuous batching (engine/scheduler.py)
    p.add_argument("--continuous", action="store_true",
                   help="route /generate through the continuous batcher")
    p.add_argument("--slots", default=8, type=int)
    p.add_argument("--decode_steps", default=1, type=int)
    p.add_argument("--prefill_chunk", default=None, type=int)
    p.add_argument("--prefix_cache", action="store_true",
                   help="automatic prompt caching across requests")
    p.add_argument("--spec_lookup", default=0, type=int,
                   help="K>0: prompt-lookup speculative decoding (greedy)")
    p.add_argument("--device", default="cuda", type=str)
    return p


class BatchedEngine:
    """The continuous-batching loop of the server: a ContinuousBatcher driven
    by a background thread. Handlers submit requests from any connection
    thread and wait for their completion events while the loop advances
    every in-flight request together. A failure in the loop is recorded and
    handed to every waiting request and every later one; ``close`` stops the
    thread."""

    def __init__(self, batcher):
        self.b = batcher
        self.lock = threading.Lock()
        self._events: dict = {}
        self._results: dict = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.error = None
        self._thread = threading.Thread(target=self._loop, name="batched-engine", daemon=True)
        self._thread.start()

    def submit(self, prompt: str, max_gen_len: int, temperature: float, top_p: float):
        with self.lock:
            if self.error is not None:
                raise RuntimeError("the batching loop failed") from self.error
            uid = self.b.add_request(prompt, max_gen_len, temperature, top_p)
            ev = threading.Event()
            self._events[uid] = ev
        self._wake.set()
        return uid, ev

    def generate(self, prompts, max_gen_len=256, temperature=0.0, top_p=0.95):
        subs = [self.submit(p, max_gen_len, temperature, top_p) for p in prompts]
        for _, ev in subs:
            ev.wait()
        with self.lock:
            if self.error is not None:
                raise RuntimeError("the batching loop failed") from self.error
            return [self._results.pop(uid) for uid, _ in subs]

    def _loop(self):
        while not self._stop.is_set():
            with self.lock:
                busy = bool(self.b.pending) or any(r is not None for r in self.b.active.values())
                if busy:
                    try:
                        done = self.b.step()
                    except Exception as e:  # the loop's boundary: fail every waiter
                        traceback.print_exc()
                        self.error = e
                        for ev in self._events.values():
                            ev.set()
                        return
                    for req in done:
                        self._results[req.uid] = self.b.tokenizer.decode(req.output_tokens)
                        ev = self._events.pop(req.uid, None)
                        if ev:
                            ev.set()
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)


_CHAT_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>accessory chat</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:780px;margin:2rem auto;
      padding:0 1rem;background:#fafafa;color:#222}
 #log{border:1px solid #ddd;background:#fff;border-radius:8px;
      padding:1rem;min-height:320px;max-height:60vh;overflow-y:auto}
 .u{color:#0b5394;margin:.5rem 0 0}.a{color:#222;white-space:pre-wrap;
      margin:.25rem 0 .75rem}
 form{display:flex;gap:.5rem;margin-top:1rem}
 input[type=text]{flex:1;padding:.6rem;border:1px solid #ccc;
      border-radius:6px}
 button{padding:.6rem 1.2rem;border:0;border-radius:6px;
      background:#0b5394;color:#fff;cursor:pointer}
 .opts{margin-top:.5rem;font-size:.85rem;color:#666}
 .opts input{width:5rem}
</style></head><body>
<h2>accessory</h2>
<div id="log"></div>
<form id="f"><input type="text" id="q" placeholder="Say something..."
 autofocus><button>Send</button></form>
<div class="opts">max_gen_len <input id="mgl" value="256">
 temperature <input id="temp" value="0.0">
 <label><input type="checkbox" id="stream"> stream (single-turn)</label>
 <button type="button" id="clear">clear</button></div>
<script>
const log=document.getElementById('log'),f=document.getElementById('f'),
      q=document.getElementById('q');let qas=[];
function add(cls,text){const d=document.createElement('div');
  d.className=cls;d.textContent=text;log.appendChild(d);
  log.scrollTop=log.scrollHeight;return d;}
document.getElementById('clear').onclick=()=>{qas=[];log.innerHTML='';};
f.onsubmit=async e=>{e.preventDefault();const msg=q.value.trim();
 if(!msg)return;q.value='';add('u','> '+msg);
 const mgl=+document.getElementById('mgl').value||256,
       temp=+document.getElementById('temp').value||0;
 if(document.getElementById('stream').checked){
   const d=add('a','');
   const r=await fetch('/stream_generate',{method:'POST',
     body:JSON.stringify({prompt:msg,max_gen_len:mgl,temperature:temp})});
   const rd=r.body.getReader(),dec=new TextDecoder();let buf='';
   for(;;){const{done,value}=await rd.read();if(done)break;
     buf+=dec.decode(value,{stream:true});
     for(const line of buf.split('\\n\\n')){if(!line.startsWith('data: '))
       continue;try{const c=JSON.parse(line.slice(6));
       if(c.end_of_content)d.textContent=c.text;
       else d.textContent+=c.text;}catch(_){}}
     buf=buf.slice(buf.lastIndexOf('\\n\\n')+2);}
 }else{
   qas.push([msg,null]);const d=add('a','...');
   const r=await fetch('/chat',{method:'POST',
     body:JSON.stringify({qas:qas,max_gen_len:mgl,temperature:temp})});
   const j=await r.json();d.textContent=j.response||j.error;
   qas[qas.length-1][1]=j.response;}
};
</script></body></html>"""


def make_handler(model, lock: threading.Lock, engine=None):
    from accessory_tpu_torch.data.conversation import default_conversation

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path in ("/", "/index.html"):
                body = _CHAT_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})

            if self.path == "/generate":
                if engine is not None and not req.get("stop"):
                    # continuous batching: concurrent requests batch onto the
                    # card (a request with stop symbols takes the Generator,
                    # whose stop matching is per call)
                    outs = engine.generate(req["prompts"],
                                           max_gen_len=req.get("max_gen_len", 256),
                                           temperature=req.get("temperature", 0.0),
                                           top_p=req.get("top_p", 0.95))
                    return self._json(200, {"outputs": outs})
                with lock:
                    outs = model.generate(req["prompts"], max_gen_len=req.get("max_gen_len", 256),
                                          temperature=req.get("temperature", 0.0),
                                          top_p=req.get("top_p", 0.95),
                                          additional_stop_symbols=tuple(req.get("stop", [])))
                return self._json(200, {"outputs": outs})

            if self.path == "/chat":
                conv = default_conversation()
                conv.load_qas(req["qas"])
                prompt = conv.get_prompt()
                with lock:
                    out = model.generate([prompt], max_gen_len=req.get("max_gen_len", 256),
                                         temperature=req.get("temperature", 0.0),
                                         additional_stop_symbols=(conv.response_end_signal,))[0]
                end = conv.response_end_signal
                if end and end in out:
                    out = out[:out.index(end)]
                return self._json(200, {"response": out.strip()})

            if self.path == "/stream_generate":
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                with lock:
                    for chunk in model.stream_generate(req["prompt"],
                                                       max_gen_len=req.get("max_gen_len", 256),
                                                       temperature=req.get("temperature", 0.0)):
                        self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                        self.wfile.flush()
                return

            self._json(404, {"error": "not found"})

        def log_message(self, *a):  # quiet
            pass

    return Handler


class _Server(ThreadingHTTPServer):
    """The HTTP server; closing it also stops the batching thread."""

    engine = None

    def server_close(self):
        super().server_close()
        if self.engine is not None:
            self.engine.close()


def serve(model, host: str = "127.0.0.1", port: int = 8080, continuous: bool = False,
          device="cuda", **batcher_kw):
    """An HTTP server over ``model`` (a MetaModel: module, args, params,
    tokenizer); ``continuous`` routes /generate through a ContinuousBatcher
    on ``device`` built with ``batcher_kw``. Returns the server, not yet
    serving: call ``serve_forever``, and ``shutdown`` / ``server_close`` to
    stop it (the latter also stops the batching thread)."""
    lock = threading.Lock()
    engine = None
    if continuous:
        from accessory_tpu_torch.engine.scheduler import ContinuousBatcher

        engine = BatchedEngine(ContinuousBatcher(model.module, model.args, model.params,
                                                 model.tokenizer, device=device, **batcher_kw))
    server = _Server((host, port), make_handler(model, lock, engine))
    server.engine = engine
    print(f"serving on http://{host}:{server.server_address[1]}"
          + (" (continuous batching)" if continuous else ""), flush=True)
    return server


def main(args) -> None:
    from accessory_tpu_torch.meta import MetaModel

    model = MetaModel.from_pretrained(args.pretrained_path, llama_type=args.llama_type,
                                      max_seq_len=args.max_seq_len, quant=args.quant,
                                      quant_bits=args.quant_bits, kv_dtype=args.kv_dtype,
                                      device=args.device)
    kw = {}
    if args.continuous:
        kw = dict(continuous=True, slots=args.slots, decode_steps=args.decode_steps,
                  prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
                  spec_lookup=args.spec_lookup, kv_dtype=args.kv_dtype)
    server = serve(model, args.host, args.port, device=args.device, **kw)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main(get_args_parser().parse_args())
