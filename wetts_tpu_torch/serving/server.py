"""HTTP synthesis server on the port's engine (copy of
wetts_tpu/serving/server.py).

Behavioral parity target: runtime/core/http/http_server.cc:38-152 — GET with
query params `text` and `name` (speaker) -> synthesize -> JSON response
{"status", "message", "audio": <base64 WAV>}; thread-per-request. `/demo`
serves a minimal browser page. `/stream` serves chunked raw int16 PCM, one
HTTP chunk per decoded audio chunk (cpu_triton_stream semantics).
`batching=True` routes `/` through serving/batcher.py's DynamicBatcher, so
concurrent requests share one engine call.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
import urllib.parse
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

logger = logging.getLogger("wetts_tpu_torch.serving")

# Minimal browser demo (replaces the reference's gradio app,
# runtime/web/app.py): text box -> GET / -> base64 WAV -> <audio> element.
DEMO_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>wetts_tpu_torch demo</title>
<style>body{font-family:sans-serif;max-width:640px;margin:3em auto}
textarea{width:100%;height:5em}button{margin-top:.5em;padding:.5em 2em}
</style></head><body>
<h2>wetts_tpu_torch &mdash; TTS demo</h2>
<textarea id="t" placeholder="Enter text..."></textarea><br>
<input id="s" placeholder="speaker (optional)">
<button onclick="go()">Synthesize</button>
<p id="status"></p><audio id="a" controls></audio>
<script>
async function go(){
  const st=document.getElementById('status');
  st.textContent='synthesizing...';
  const t=encodeURIComponent(document.getElementById('t').value);
  const s=encodeURIComponent(document.getElementById('s').value);
  const r=await fetch(`/?text=${t}&name=${s}`);
  const j=await r.json();
  if(j.status!=='ok'){st.textContent='error: '+j.message;return;}
  document.getElementById('a').src='data:audio/wav;base64,'+j.audio;
  document.getElementById('a').play();
  st.textContent='done';
}
</script></body></html>"""


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class TtsServer:
    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8080,
                 batching: bool = False, max_batch: int = 8,
                 max_delay_s: float = 0.005):
        self.engine = engine
        self.host = host
        self.port = port
        self._httpd = None
        # cross-request dynamic batching (Triton dynamic_batching analog);
        # the engine serializes every path that reaches it (engine.lock).
        # max_batch and max_delay_s are the JAX server's parameters: the
        # most requests, and the longest wait, the dispatcher gathers
        self.batcher = None
        if batching:
            from wetts_tpu_torch.serving.batcher import DynamicBatcher

            self.batcher = DynamicBatcher(engine, max_batch=max_batch,
                                          max_delay_s=max_delay_s)

    def _synthesize(self, text: str, name):
        if self.batcher is not None:
            return self.batcher.synthesize(text, name)
        return self.engine.synthesize(text, name)

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send_json(self, code: int, payload: dict):
                body = json.dumps(payload).encode("utf8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                params = dict(urllib.parse.parse_qsl(parsed.query))
                text = params.get("text", "")
                name = params.get("name")
                if parsed.path == "/demo":
                    body = DEMO_PAGE.encode("utf8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if not text:
                    self._send_json(400, {"status": "failed",
                                          "message": "missing `text` param"})
                    return
                if parsed.path == "/stream":
                    self._stream(text, name)
                    return
                try:
                    audio = server._synthesize(text, name)
                    wav = wav_bytes(audio, server.engine.sample_rate)
                    self._send_json(200, {
                        "status": "ok",
                        "message": "success",
                        "sample_rate": server.engine.sample_rate,
                        "audio": base64.b64encode(wav).decode("ascii"),
                    })
                except Exception as e:  # noqa: BLE001 - report, keep serving
                    logger.exception("synthesis failed")
                    self._send_json(500, {"status": "failed",
                                          "message": str(e)})

            def _stream(self, text: str, name):
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for piece in server.engine.stream_synthesize(text, name):
                        pcm = (np.clip(piece, -1, 1)
                               * 32767.0).astype(np.int16).tobytes()
                        self.wfile.write(f"{len(pcm):x}\r\n".encode())
                        self.wfile.write(pcm + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client went away mid-stream

        return Handler

    def _bind(self):
        if self._httpd is None:
            self._httpd = ThreadingHTTPServer((self.host, self.port),
                                              self.make_handler())
            self.port = self._httpd.server_address[1]  # port 0: the OS's

    def serve_forever(self):
        self._bind()
        self._httpd.serve_forever()

    def start_background(self):
        # bind synchronously so the port is accepting before this returns
        self._bind()
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self.batcher is not None:
            self.batcher.shutdown()
