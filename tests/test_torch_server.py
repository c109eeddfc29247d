"""The port's HTTP server (``demos/server.py``) and its dialog templates
(``data/conversation.py``), on the CPU: ``serve(..., port=0,
continuous=True)`` on 127.0.0.1 answers concurrent ``/generate`` posts
through the continuous batcher with the text of ``MetaModel.generate``
(greedy), and ``/health``, ``/chat``, ``/stream_generate`` and the page;
closing the server stops the batching thread. ``main`` wires the command
line into ``from_pretrained`` and ``serve``. The templates render the JAX
package's prompts. Same model and tokenizer as test_torch_scheduler.py.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from accessory_tpu.data import conversation as jconv

from accessory_tpu_torch.data import conversation as tconv
from accessory_tpu_torch.demos import server as tserver

from test_torch_scheduler import make_models


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_models(tmp_path_factory)[1]


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.read().decode()


def _started(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def test_continuous_server_round_trip(model):
    prompts = ["hello world", "the quick", "brown fox jumps", "this is"]
    want = model.generate(prompts, max_gen_len=5)
    server = tserver.serve(model, host="127.0.0.1", port=0, continuous=True, device="cpu",
                           slots=2, page_size=32, decode_steps=2, prefix_cache=True)
    port = server.server_address[1]
    thread = _started(server)
    try:
        results = {}

        def post(i, p):
            status, ctype, body = _post(port, "/generate", {"prompts": [p], "max_gen_len": 5})
            results[i] = (status, ctype, json.loads(body)["outputs"])

        ts = [threading.Thread(target=post, args=(i, p)) for i, p in enumerate(prompts)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert [results[i] for i in range(4)] == [(200, "application/json", [w]) for w in want]
        # several prompts in one post go through the batcher together
        status, _, body = _post(port, "/generate", {"prompts": prompts[:2], "max_gen_len": 5})
        assert status == 200 and json.loads(body)["outputs"] == want[:2]
        assert _get(port, "/health") == (200, json.dumps({"status": "ok"}))
        status, page = _get(port, "/")
        assert status == 200 and "<html>" in page

        status, _, body = _post(port, "/chat", {"qas": [["hello world", None]], "max_gen_len": 4})
        conv = tconv.default_conversation()
        conv.load_qas([["hello world", None]])
        out = model.generate([conv.get_prompt()], max_gen_len=4,
                             additional_stop_symbols=(conv.response_end_signal,))[0]
        if conv.response_end_signal in out:
            out = out[:out.index(conv.response_end_signal)]
        assert status == 200 and json.loads(body) == {"response": out.strip()}

        status, ctype, body = _post(port, "/stream_generate", {"prompt": "hello world",
                                                               "max_gen_len": 5})
        events = [json.loads(line[len("data: "):]) for line in body.split("\n\n") if line]
        assert status == 200 and ctype == "text/event-stream"
        assert events[-1]["end_of_content"] and not any(e["end_of_content"] for e in events[:-1])
        assert events[-1]["text"] == want[0]

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/nowhere", {})
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
    thread.join(timeout=60)
    engine = server.engine
    assert not thread.is_alive() and not engine._thread.is_alive() and engine.error is None


def test_plain_server_generate_with_stop(model):
    """Without --continuous (and for a request with stop symbols) /generate
    calls MetaModel.generate under the lock."""
    want = model.generate(["the quick"], max_gen_len=4, additional_stop_symbols=("zz",))
    server = tserver.serve(model, host="127.0.0.1", port=0, device="cpu")
    port = server.server_address[1]
    thread = _started(server)
    try:
        status, _, body = _post(port, "/generate", {"prompts": ["the quick"], "max_gen_len": 4,
                                                    "stop": ["zz"]})
        assert status == 200 and json.loads(body)["outputs"] == want
    finally:
        server.shutdown()
        server.server_close()
    thread.join(timeout=60)
    assert server.engine is None


def test_main_wires_the_command_line(model, monkeypatch):
    """main loads through MetaModel.from_pretrained and serves with the
    batcher's options."""
    seen = {}

    def fake_from_pretrained(path, **kw):
        seen["load"] = (path, kw)
        return model

    class Stub:
        def serve_forever(self):
            seen["served"] = True

        def server_close(self):
            seen["closed"] = True

    def fake_serve(m, host, port, **kw):
        seen["serve"] = (m, host, port, kw)
        return Stub()

    from accessory_tpu_torch import meta

    monkeypatch.setattr(meta.MetaModel, "from_pretrained", staticmethod(fake_from_pretrained))
    monkeypatch.setattr(tserver, "serve", fake_serve)
    args = tserver.get_args_parser().parse_args(
        ["--pretrained_path", "ckpt", "--quant", "--continuous", "--slots", "4",
         "--decode_steps", "8", "--kv_dtype", "int8", "--port", "0", "--device", "cpu"])
    tserver.main(args)
    path, kw = seen["load"]
    assert path == "ckpt" and kw["quant"] and kw["kv_dtype"] == "int8" and kw["device"] == "cpu"
    m, host, port, kw = seen["serve"]
    assert m is model and (host, port) == ("127.0.0.1", 0)
    assert kw == dict(device="cpu", continuous=True, slots=4, decode_steps=8, prefill_chunk=None,
                      prefix_cache=False, spec_lookup=0, kv_dtype="int8")
    assert seen["served"] and seen["closed"]


@pytest.mark.parametrize("name", sorted(jconv.CONV_TEMPLATES))
def test_conversation_templates_render_the_reference_prompts(name):
    qas = [["hi there", "hello!"], ["what is two and two", None]]
    jc, tc = jconv.CONV_TEMPLATES[name](), tconv.CONV_TEMPLATES[name]()
    jc.load_qas(qas)
    tc.load_qas(qas)
    assert tc.get_prompt() == jc.get_prompt()
    assert tc.response_end_signal == jc.response_end_signal
    assert sorted(tconv.CONV_TEMPLATES) == sorted(jconv.CONV_TEMPLATES)
    assert tconv.default_conversation().get_prompt() == jconv.default_conversation().get_prompt()
