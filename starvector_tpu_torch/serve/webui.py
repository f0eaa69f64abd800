"""Web UI gateway: a single-page app and a streaming proxy (port of
starvector_tpu/serve/webui.py, on the standard library's HTTP server,
serve/httpd.py, in place of aiohttp).

The page is the JAX package's, unchanged (the reference's Gradio controls:
task, image upload and mode, temperature, top-p, max tokens, beams, length
penalty; a streamed code view with a live SVG preview; votes). Routes:
  GET  /              the page
  POST /api/generate  the upstream's /worker_generate_stream chunks
                      (b'{json}\\0'), passed through as they arrive
  POST /api/vote      the JSON body, with a timestamp, appended to
                      <log_dir>/votes.jsonl

The proxy posts to `upstream + "/worker_generate_stream"`, whatever the
flag that names it (`--controller`), as the JAX web UI does: point it at a
worker (serve/worker.py).

Run:
    python -m starvector_tpu_torch.serve.webui --controller http://localhost:21002
(`--device cpu` where no card is visible: the web UI computes nothing
itself, but starts, as every entry point of the port, only where a card is
visible unless asked for the CPU.)
"""

from __future__ import annotations

import argparse
import json
import os
import time

from starvector_tpu_torch import require_device
from starvector_tpu_torch.serve.httpd import make_server, post_json

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>StarVector TPU</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1c2430}
 header{background:#13233f;color:#fff;padding:14px 22px;font-size:18px}
 main{display:grid;grid-template-columns:320px 1fr 1fr;gap:16px;padding:16px}
 section{background:#fff;border:1px solid #dde3ea;border-radius:10px;padding:14px}
 h3{margin:2px 0 10px;font-size:14px;text-transform:uppercase;letter-spacing:.04em;color:#5a6676}
 label{display:block;font-size:13px;margin:10px 0 2px}
 input[type=range]{width:100%}
 textarea{width:100%;height:380px;font-family:ui-monospace,monospace;font-size:12px;border:1px solid #dde3ea;border-radius:6px}
 #preview{width:100%;height:380px;border:1px dashed #c6cdd6;border-radius:6px;display:flex;align-items:center;justify-content:center;background:#fff}
 #preview svg{max-width:100%;max-height:100%}
 button{background:#2458c5;color:#fff;border:none;border-radius:6px;padding:9px 16px;cursor:pointer;margin-top:12px}
 button[disabled]{opacity:.5}
 .vote{background:#eef2f8;color:#1c2430;margin-right:6px}
 #status{font-size:12px;color:#5a6676;margin-top:8px;min-height:16px}
</style></head>
<body>
<header>⭐ StarVector — TPU serving demo</header>
<main>
 <section>
  <h3>Input</h3>
  <label>Task
   <select id="task"><option value="im2svg">Image → SVG</option>
   <option value="text2svg">Text → SVG</option></select></label>
  <div id="imgbox">
   <label>Image <input type="file" id="image" accept="image/*"></label>
   <label>Image mode
    <select id="imgmode"><option>Pad</option><option>Resize</option></select></label>
  </div>
  <div id="textbox" style="display:none">
   <label>Caption <input type="text" id="caption" style="width:100%"></label>
  </div>
  <label>Temperature <span id="tval">0.2</span>
   <input type="range" id="temp" min="0" max="1.5" step="0.05" value="0.2"></label>
  <label>Top-p <span id="pval">0.9</span>
   <input type="range" id="topp" min="0.1" max="1" step="0.05" value="0.9"></label>
  <label>Max tokens <span id="mval">2000</span>
   <input type="range" id="maxtok" min="64" max="7800" step="64" value="2000"></label>
  <label>Beams <span id="bval">1</span>
   <input type="range" id="beams" min="1" max="6" step="1" value="1"></label>
  <label>Length penalty <span id="lval">1.0</span>
   <input type="range" id="lenpen" min="0.5" max="2" step="0.1" value="1.0"></label>
  <button id="go">Generate</button>
  <div>
   <button class="vote" id="up">👍</button>
   <button class="vote" id="down">👎</button>
  </div>
  <div id="status"></div>
 </section>
 <section><h3>SVG code</h3><textarea id="code" readonly></textarea></section>
 <section><h3>Preview</h3><div id="preview"></div></section>
</main>
<script>
const $=id=>document.getElementById(id);
$('task').onchange=()=>{const t=$('task').value;
 $('imgbox').style.display=t==='im2svg'?'':'none';
 $('textbox').style.display=t==='text2svg'?'':'none';};
for(const [r,v] of [['temp','tval'],['topp','pval'],['maxtok','mval'],
                    ['beams','bval'],['lenpen','lval']])
 $(r).oninput=()=>$(v).textContent=$(r).value;
function render(svg){try{$('preview').innerHTML=svg;}catch(e){}}
$('go').onclick=async()=>{
 const task=$('task').value;
 const payload={task,temperature:+$('temp').value,top_p:+$('topp').value,
                max_new_tokens:+$('maxtok').value,model:'starvector',
                num_beams:+$('beams').value,
                length_penalty:+$('lenpen').value};
 if(task==='im2svg'){
  const f=$('image').files[0];
  if(!f){$('status').textContent='choose an image first';return;}
  payload.image=await new Promise(res=>{const r=new FileReader();
   r.onload=()=>res(r.result.split(',')[1]);r.readAsDataURL(f);});
 } else { payload.prompt=$('caption').value; }
 $('go').disabled=true;$('status').textContent='generating…';$('code').value='';
 const resp=await fetch('/api/generate',{method:'POST',
   headers:{'Content-Type':'application/json'},body:JSON.stringify(payload)});
 const reader=resp.body.getReader();const dec=new TextDecoder();let buf='';
 while(true){const {done,value}=await reader.read();if(done)break;
  buf+=dec.decode(value,{stream:true});
  const parts=buf.split('\\0');buf=parts.pop();
  for(const p of parts){if(!p)continue;const d=JSON.parse(p);
   $('code').value=d.text;render(d.text);}}
 $('status').textContent='done';$('go').disabled=false;};
for(const[btn,v] of [['up',1],['down',-1]])
 $(btn).onclick=()=>fetch('/api/vote',{method:'POST',
  headers:{'Content-Type':'application/json'},
  body:JSON.stringify({vote:v,svg:$('code').value})});
</script>
</body></html>
"""


def build_server(upstream: str, log_dir: str = "serve_logs", host: str = "127.0.0.1",
                 port: int = 0):
    """The web UI's HTTP server (httpd.make_server) in front of the worker
    at `upstream` (its base URL), logging votes under `log_dir`."""
    os.makedirs(log_dir, exist_ok=True)
    page = INDEX_HTML.encode()

    def index(h):
        h.send_body(page, "text/html; charset=utf-8")

    def generate(h, payload):
        h.start_stream()
        with post_json(upstream + "/worker_generate_stream", payload, timeout=600) as up:
            while chunk := up.read1(1 << 16):
                h.write_chunk(chunk)

    def vote(h, data):
        record = {"ts": time.time(), **data}
        with open(os.path.join(log_dir, "votes.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
        h.send_json({})

    return make_server(host, port, {"/api/generate": generate, "/api/vote": vote},
                       {"/": index})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller", default="http://localhost:21001",
                        help="controller (or worker) base URL to stream from")
    parser.add_argument("--log-dir", default="serve_logs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    require_device(args.device, "--device cpu")
    server = build_server(args.controller, args.log_dir, args.host, args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
