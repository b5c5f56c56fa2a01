"""Browser chat UI, served by the stdlib HTTP API.

The reference ships a Streamlit chat app (src/app.py: model selector,
streamed answer into a placeholder, expandable sources panel with
cleaned section ids + guideline URLs, suggested-query buttons, 👍/👎
feedback appended to a JSON log). Streamlit is not installable in every
deployment, so this module renders the same surface as one
self-contained HTML page (no CDN assets, no build step) that talks to
the production endpoints:

* ``POST /v1/rag/stream`` — the page reads the SSE body incrementally
  and types the answer into the chat as deltas arrive (the reference's
  placeholder-streaming behavior, src/app.py:212-229).
* ``POST /v1/feedback``   — thumbs up/down per answer (src/app.py:36-58).

Everything dynamic (LLM options, suggested queries, default knobs) is
injected server-side so the page never hardcodes deployment config.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

LLM_OPTIONS = [
    "gpt-4.1-mini",
    "gpt-4.1-nano",
    "gpt-4.1",
    "o4-mini",
    "gemini-2.5-flash",
    "claude-sonnet-4",
]

SUGGESTED_QUERIES = [
    "What are the recommended interventions for smoking cessation in adults?",
    "What groups are at higher risk of ADHD?",
]

DEFAULT_SETTINGS: Dict[str, object] = {
    "similarity_k": 15,
    "common_sections_n": 15,
    "use_hybrid_search": False,
    "use_reranker": True,
}

_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>NICE Guidelines RAG</title>
<style>
  :root {
    --bg: #0f1115; --panel: #181b22; --panel2: #1f232c;
    --text: #e8eaf0; --dim: #9aa3b2; --accent: #4f8cff;
    --user: #2b3a55; --border: #2a2f3a; --good: #3fb68b; --bad: #e06c75;
  }
  * { box-sizing: border-box; }
  body {
    margin: 0; background: var(--bg); color: var(--text);
    font: 15px/1.5 system-ui, -apple-system, "Segoe UI", sans-serif;
    display: flex; height: 100vh;
  }
  #sidebar {
    width: 280px; min-width: 280px; background: var(--panel);
    border-right: 1px solid var(--border); padding: 18px;
    display: flex; flex-direction: column; gap: 14px; overflow-y: auto;
  }
  #sidebar h1 { font-size: 17px; margin: 0 0 4px; }
  #sidebar .sub { color: var(--dim); font-size: 12.5px; margin-bottom: 8px; }
  label { display: block; font-size: 12.5px; color: var(--dim); margin-bottom: 4px; }
  select, input[type=number] {
    width: 100%; background: var(--panel2); color: var(--text);
    border: 1px solid var(--border); border-radius: 6px; padding: 7px 9px;
    font-size: 14px;
  }
  .toggle { display: flex; align-items: center; gap: 8px; font-size: 14px; color: var(--text); }
  .toggle input { accent-color: var(--accent); }
  #main { flex: 1; display: flex; flex-direction: column; min-width: 0; }
  #chat { flex: 1; overflow-y: auto; padding: 24px 12%; }
  .msg { margin-bottom: 18px; max-width: 100%; }
  .msg .who { font-size: 12px; color: var(--dim); margin-bottom: 4px; }
  .bubble {
    background: var(--panel); border: 1px solid var(--border);
    border-radius: 10px; padding: 12px 14px; white-space: pre-wrap;
    overflow-wrap: break-word;
  }
  .msg.user .bubble { background: var(--user); }
  .bubble a { color: var(--accent); }
  .cursor::after { content: "▌"; animation: blink 1s step-start infinite; color: var(--accent); }
  @keyframes blink { 50% { opacity: 0; } }
  details.sources {
    margin-top: 8px; background: var(--panel2); border: 1px solid var(--border);
    border-radius: 8px; padding: 8px 12px; font-size: 13px;
  }
  details.sources summary { cursor: pointer; color: var(--dim); }
  details.sources li { margin: 4px 0; }
  .fb { margin-top: 6px; display: flex; gap: 6px; align-items: center; }
  .fb button {
    background: var(--panel2); border: 1px solid var(--border); color: var(--text);
    border-radius: 6px; padding: 3px 10px; cursor: pointer; font-size: 14px;
  }
  .fb button:hover { border-color: var(--accent); }
  .fb button.sel-up { border-color: var(--good); color: var(--good); }
  .fb button.sel-down { border-color: var(--bad); color: var(--bad); }
  .fb .thanks { color: var(--dim); font-size: 12px; }
  #suggest { padding: 0 12% 6px; display: flex; gap: 8px; flex-wrap: wrap; }
  #suggest button {
    background: var(--panel); border: 1px solid var(--border); color: var(--dim);
    border-radius: 16px; padding: 6px 14px; cursor: pointer; font-size: 13px;
  }
  #suggest button:hover { border-color: var(--accent); color: var(--text); }
  #inputbar {
    display: flex; gap: 10px; padding: 14px 12% 20px;
    border-top: 1px solid var(--border); background: var(--bg);
  }
  #query {
    flex: 1; background: var(--panel2); color: var(--text);
    border: 1px solid var(--border); border-radius: 8px; padding: 11px 13px;
    font-size: 15px;
  }
  #send {
    background: var(--accent); color: #fff; border: 0; border-radius: 8px;
    padding: 0 22px; font-size: 15px; cursor: pointer;
  }
  #send:disabled { opacity: 0.5; cursor: default; }
  .err { color: var(--bad); }
  #health { font-size: 12px; color: var(--dim); margin-top: auto; }
</style>
</head>
<body>
<div id="sidebar">
  <div>
    <h1>NICE Guidelines RAG</h1>
    <div class="sub">Hybrid retrieval on the GPU over NICE clinical guidelines</div>
  </div>
  <div>
    <label for="llm">LLM</label>
    <select id="llm"></select>
  </div>
  <div>
    <label for="simk">Similarity k</label>
    <input type="number" id="simk" min="1" max="100">
  </div>
  <div class="toggle"><input type="checkbox" id="hybrid"> <span>Hybrid search (BM25 + dense)</span></div>
  <div class="toggle"><input type="checkbox" id="rerank"> <span>Rerank results</span></div>
  <div id="health"></div>
</div>
<div id="main">
  <div id="chat"></div>
  <div id="suggest"></div>
  <div id="inputbar">
    <input id="query" placeholder="Ask about NICE clinical guidelines…" autocomplete="off">
    <button id="send">Send</button>
  </div>
</div>
<script id="boot" type="application/json">__BOOT__</script>
<script>
"use strict";
const BOOT = JSON.parse(document.getElementById("boot").textContent);
const $ = (id) => document.getElementById(id);
const chat = $("chat"), queryBox = $("query"), sendBtn = $("send");

for (const m of BOOT.llm_options) {
  const o = document.createElement("option");
  o.value = o.textContent = m;
  $("llm").appendChild(o);
}
$("simk").value = BOOT.defaults.similarity_k;
$("hybrid").checked = !!BOOT.defaults.use_hybrid_search;
$("rerank").checked = !!BOOT.defaults.use_reranker;
for (const q of BOOT.suggested_queries) {
  const b = document.createElement("button");
  b.textContent = q;
  b.onclick = () => { queryBox.value = q; submit(); };
  $("suggest").appendChild(b);
}
fetch("v1/health").then(r => r.json()).then(h => {
  const src = Object.entries(h.sources || {}).map(
    ([k, v]) => `${k}: ${v.n_docs} chunks`).join(", ");
  $("health").textContent = `index — ${src}`;
}).catch(() => {});

function cleanSectionId(id, source) {
  if (!id || id === "Unknown section") return id;
  let out = id;
  if (out.startsWith(source + "_")) out = out.slice(source.length + 1);
  return out.replace(/_/g, " ").replace(/\\s+/g, " ").trim();
}

function addMsg(who, text) {
  const div = document.createElement("div");
  div.className = "msg " + who;
  const label = who === "user" ? "You" : "Assistant";
  div.innerHTML = `<div class="who">${label}</div><div class="bubble"></div>`;
  div.querySelector(".bubble").textContent = text;
  chat.appendChild(div);
  chat.scrollTop = chat.scrollHeight;
  return div;
}

function renderSources(holder, sources) {
  if (!sources || !sources.length) return;
  const det = document.createElement("details");
  det.className = "sources";
  const items = sources.map(s => {
    const label = `${s.source} — ${cleanSectionId(s.section_id, s.source)}`;
    return s.url && s.url !== "Unknown"
      ? `<li><a href="${s.url}" target="_blank" rel="noopener">${label}</a></li>`
      : `<li>${label}</li>`;
  }).join("");
  det.innerHTML = `<summary>Sources (${sources.length})</summary><ul>${items}</ul>`;
  holder.appendChild(det);
}

function renderFeedback(holder, query, answerEl, sources) {
  const bar = document.createElement("div");
  bar.className = "fb";
  const mk = (rating, glyph, cls) => {
    const b = document.createElement("button");
    b.textContent = glyph;
    b.onclick = async () => {
      bar.querySelectorAll("button").forEach(x => x.disabled = true);
      b.classList.add(cls);
      await fetch("v1/feedback", {
        method: "POST",
        headers: {"Content-Type": "application/json"},
        body: JSON.stringify({
          query, rating,
          response: answerEl.textContent,
          llm_model: $("llm").value,
          sources,
        }),
      }).catch(() => {});
      const t = document.createElement("span");
      t.className = "thanks"; t.textContent = "Thanks for the feedback!";
      bar.appendChild(t);
    };
    return b;
  };
  bar.appendChild(mk("up", "👍", "sel-up"));
  bar.appendChild(mk("down", "👎", "sel-down"));
  holder.appendChild(bar);
}

async function submit() {
  const query = queryBox.value.trim();
  if (!query || sendBtn.disabled) return;
  queryBox.value = "";
  sendBtn.disabled = true;
  addMsg("user", query);
  const msg = addMsg("assistant", "");
  const bubble = msg.querySelector(".bubble");
  bubble.classList.add("cursor");
  let sources = [];
  try {
    const resp = await fetch("v1/rag/stream", {
      method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({
        query,
        llm_model: $("llm").value,
        similarity_k: parseInt($("simk").value, 10) || 15,
        common_sections_n: BOOT.defaults.common_sections_n,
        use_hybrid_search: $("hybrid").checked,
        use_reranker: $("rerank").checked,
      }),
    });
    if (!resp.ok) {
      const e = await resp.json().catch(() => ({error: resp.statusText}));
      throw new Error(e.error || resp.statusText);
    }
    const reader = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = "", event = null;
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let nl;
      while ((nl = buf.indexOf("\\n")) >= 0) {
        const line = buf.slice(0, nl); buf = buf.slice(nl + 1);
        if (line.startsWith("event: ")) { event = line.slice(7).trim(); continue; }
        if (!line.startsWith("data: ")) { if (!line.trim()) event = null; continue; }
        const data = line.slice(6);
        if (data === "[DONE]") continue;
        const obj = JSON.parse(data);
        if (event === "sources") { sources = obj.sources || []; event = null; continue; }
        if (obj.delta) {
          bubble.textContent += obj.delta;
          chat.scrollTop = chat.scrollHeight;
        }
      }
    }
  } catch (err) {
    const e = document.createElement("div");
    e.className = "err"; e.textContent = "Error: " + err.message;
    bubble.appendChild(e);
  } finally {
    bubble.classList.remove("cursor");
    renderSources(msg, sources);
    renderFeedback(msg, query, bubble, sources);
    sendBtn.disabled = false;
    queryBox.focus();
  }
}
sendBtn.onclick = submit;
queryBox.addEventListener("keydown", (e) => { if (e.key === "Enter") submit(); });
queryBox.focus();
</script>
</body>
</html>
"""


def render_page(
    llm_options: Optional[Sequence[str]] = None,
    suggested_queries: Optional[Sequence[str]] = None,
    defaults: Optional[Dict[str, object]] = None,
) -> str:
    """The chat page with deployment config injected as a JSON boot blob."""
    boot = {
        "llm_options": list(llm_options or LLM_OPTIONS),
        "suggested_queries": list(suggested_queries or SUGGESTED_QUERIES),
        "defaults": {**DEFAULT_SETTINGS, **(defaults or {})},
    }
    # </script> inside a JSON string would terminate the boot block early.
    blob = json.dumps(boot).replace("</", "<\\/")
    return _PAGE.replace("__BOOT__", blob)
