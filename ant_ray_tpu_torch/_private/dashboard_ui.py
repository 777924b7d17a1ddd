"""The dashboard web UI: one self-contained HTML page (no build step,
no bundled JS framework) served at ``/``, polling the REST API the
dashboard already exposes (ref capability: python/ray/dashboard/ —
the reference ships a React SPA; this stack serves an equivalent
operator view as a static page, so the UI works wherever the head
runs with zero frontend toolchain).
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>ant-ray-tpu dashboard</title>
<style>
  :root { --fg:#1a1a2e; --muted:#667; --line:#e3e3ee; --accent:#34508c;
          --bg:#fafafc; --card:#fff; }
  body { margin:0; font:14px/1.45 system-ui,sans-serif; color:var(--fg);
         background:var(--bg); }
  header { padding:10px 20px; background:var(--card);
           border-bottom:1px solid var(--line); display:flex;
           align-items:baseline; gap:16px; }
  header h1 { font-size:16px; margin:0; }
  header span { color:var(--muted); font-size:12px; }
  nav { display:flex; gap:2px; padding:0 20px; background:var(--card);
        border-bottom:1px solid var(--line); }
  nav button { border:0; background:none; padding:9px 14px; font:inherit;
               cursor:pointer; color:var(--muted);
               border-bottom:2px solid transparent; }
  nav button.active { color:var(--accent);
                      border-bottom-color:var(--accent); }
  main { padding:16px 20px; max-width:1100px; }
  table { border-collapse:collapse; width:100%; background:var(--card);
          border:1px solid var(--line); margin-bottom:18px; }
  th, td { text-align:left; padding:6px 10px;
           border-bottom:1px solid var(--line); vertical-align:top; }
  th { font-weight:600; font-size:12px; color:var(--muted);
       text-transform:uppercase; letter-spacing:.03em; }
  tr:last-child td { border-bottom:0; }
  code, pre { font:12px/1.4 ui-monospace,monospace; }
  pre { background:var(--card); border:1px solid var(--line);
        padding:10px; overflow:auto; max-height:480px; }
  .dead { color:#a33; } .alive { color:#286b3c; }
  h2 { font-size:14px; margin:18px 0 8px; }
  form { margin-bottom:14px; display:flex; gap:8px; }
  input[type=text] { flex:1; padding:6px 8px; font:inherit;
                     border:1px solid var(--line); border-radius:3px; }
  button.act { padding:6px 12px; font:inherit; cursor:pointer;
               border:1px solid var(--accent); background:var(--accent);
               color:#fff; border-radius:3px; }
  a { color:var(--accent); }
  .err { color:#a33; white-space:pre-wrap; }
</style>
</head>
<body>
<header><h1>ant-ray-tpu</h1><span id="meta">connecting…</span></header>
<nav id="tabs"></nav>
<main id="view">loading…</main>
<script>
"use strict";
const TABS = ["overview","nodes","actors","placement groups","jobs",
              "logs"];
let tab = "overview", timer = null, logFile = null;

const $ = (h) => { const d = document.createElement("div");
                   d.innerHTML = h; return d; };
const esc = (s) => String(s ?? "").replace(/[&<>"']/g,
    c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;",
           "'":"&#39;"}[c]));
const get = async (p) => { const r = await fetch(p);
                           if (!r.ok) throw new Error(p+": "+r.status);
                           return r.json(); };
const fmtRes = (o) => Object.entries(o || {})
    .map(([k, v]) => k+": "+(+(+v).toFixed(2))).join(", ");
const table = (heads, rows) =>
    "<table><tr>" + heads.map(h => "<th>"+h+"</th>").join("") + "</tr>" +
    (rows.length ? rows.map(r => "<tr>" + r.map(c => "<td>"+c+"</td>")
     .join("") + "</tr>").join("")
     : "<tr><td colspan="+heads.length+">none</td></tr>") + "</table>";

async function renderOverview() {
  const [s, actors, pgs, jobs] = await Promise.all([
      get("/api/cluster_status"), get("/api/actors"),
      get("/api/placement_groups"), get("/api/jobs")]);
  const avail = s.resources_available || {},
        tot = s.resources_total || {};
  const rows = Object.keys(tot).sort().map(k =>
      [esc(k), +(+ (avail[k] ?? 0)).toFixed(2), +(+tot[k]).toFixed(2)]);
  return "<h2>Cluster</h2>" +
    table(["", ""], [["Alive nodes", s.nodes_alive ?? "?"],
                     ["Dead nodes", s.nodes_dead ?? 0],
                     ["Actors", actors.length],
                     ["Placement groups", Object.keys(pgs).length],
                     ["Jobs", jobs.length]]) +
    "<h2>Resources</h2>" +
    table(["Resource", "Available", "Total"], rows) +
    "<p><a href='/metrics'>Prometheus metrics</a> · " +
    "<a href='/api/timeline'>Chrome timeline (JSON)</a> · " +
    "<a href='/api/insight'>Flow insight</a></p>";
}

async function renderNodes() {
  const nodes = await get("/api/nodes");
  return table(
    ["Node", "State", "Address", "Available", "Total", "Labels"],
    nodes.map(n => [
      "<code>"+esc((n.node_id||"").slice(0,12))+"</code>",
      n.alive ? "<span class=alive>ALIVE</span>"
              : "<span class=dead>DEAD</span>",
      esc(n.address || ""),
      esc(fmtRes(n.available_resources)),
      esc(fmtRes(n.total_resources)),
      esc(Object.entries(n.labels || {})
          .map(([k,v]) => k+"="+v).join(", "))]));
}

async function renderActors() {
  const actors = await get("/api/actors");
  return table(["Actor", "Class", "State", "Name", "Death reason"],
    actors.map(a => [
      "<code>"+esc((a.actor_id||"").slice(0,12))+"</code>",
      esc(a.class_name || ""),
      a.state === "ALIVE" ? "<span class=alive>ALIVE</span>"
                          : esc(a.state || ""),
      esc(a.name || ""), esc(a.death_reason || "")]));
}

async function renderPgs() {
  const pgs = await get("/api/placement_groups");
  return table(["PG", "Name", "Strategy", "State", "Bundles"],
    Object.entries(pgs).map(([id, p]) => [
      "<code>"+esc(id.slice(0,12))+"</code>",
      esc(p.name||""), esc(p.strategy||""), esc(p.state||""),
      esc((p.bundles||[]).map(b => fmtRes(b)).join(" | "))]));
}

async function renderJobs() {
  const jobs = await get("/api/jobs");
  const rows = jobs.map(j => [
      "<code>"+esc(j.submission_id||"")+"</code>",
      esc(j.entrypoint||""), esc(j.status||""),
      "<a href='#' class=joblink data-job=\\""+esc(j.submission_id)+
      "\\">logs</a>"]);
  return "<form onsubmit='submitJob(event)'>" +
    "<input type=text id=entry placeholder='entrypoint, e.g. python my_script.py'>" +
    "<button class=act>Submit job</button></form>" +
    table(["Job", "Entrypoint", "Status", ""], rows) +
    "<div id=joblog>" + jobLogHtml + "</div>";
}

window.submitJob = async (ev) => {
  ev.preventDefault();
  const entrypoint = document.getElementById("entry").value.trim();
  if (!entrypoint) return;
  await fetch("/api/jobs", {method:"POST",
      headers:{"content-type":"application/json"},
      body: JSON.stringify({entrypoint})});
  render();
};
let jobLogHtml = "";
window.jobLogs = async (id) => {
  const out = await get("/api/jobs/"+id+"/logs");
  jobLogHtml = "<h2>logs: "+esc(id)+"</h2><pre>"+esc(out.logs)+
               "</pre>";
  const el = document.getElementById("joblog");
  if (el) el.innerHTML = jobLogHtml;
};
document.addEventListener("click", (ev) => {
  const a = ev.target.closest("a.joblink, a.loglink");
  if (!a) return;
  ev.preventDefault();
  if (a.classList.contains("joblink")) jobLogs(a.dataset.job);
  else openLog(a.dataset.file, a.dataset.node);
});

async function renderLogs() {
  const nodes = await get("/api/logs");
  let html = "";
  for (const n of nodes) {
    html += "<h2>node <code>"+esc(n.node_id.slice(0,12))+"</code></h2>" +
      table(["File", "Bytes"], (n.files||[]).map(f => [
        "<a href='#' class=loglink data-file=\\""+esc(f.filename)+
        "\\" data-node=\\""+esc(n.node_id)+"\\">"+
        esc(f.filename)+"</a>",
        esc(f.size ?? "")]));
  }
  if (logFile) {
    const body = await get("/api/logs/" + encodeURIComponent(logFile) +
        "?tail=200&node_id=" + encodeURIComponent(logNode || ""));
    html += "<h2>"+esc(logFile)+"</h2><pre>" +
            esc(body.error || body.data) + "</pre>";
  }
  return html;
}
let logNode = null;\nwindow.openLog = (f, n) => { logFile = f; logNode = n; render(); };

const RENDER = {"overview": renderOverview, "nodes": renderNodes,
                "actors": renderActors, "placement groups": renderPgs,
                "jobs": renderJobs, "logs": renderLogs};

async function render(auto) {
  const entry = document.getElementById("entry");
  if (auto && entry && (document.activeElement === entry ||
                        entry.value)) {
    return;    // don't wipe in-progress input on the refresh tick
  }
  const view = document.getElementById("view");
  try {
    view.innerHTML = await RENDER[tab]();
    document.getElementById("meta").textContent =
        new Date().toLocaleTimeString();
  } catch (e) {
    view.innerHTML = "<p class=err>"+esc(e)+"</p>";
  }
}

function setTab(t) {
  tab = t; logFile = null;
  document.querySelectorAll("nav button").forEach(b =>
      b.classList.toggle("active", b.textContent === t));
  render();
}

const nav = document.getElementById("tabs");
TABS.forEach(t => {
  const b = document.createElement("button");
  b.textContent = t;
  b.onclick = () => setTab(t);
  nav.appendChild(b);
});
setTab("overview");
timer = setInterval(() => render(true), 4000);
</script>
</body>
</html>
"""
