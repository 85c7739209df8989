"""The human half of the serve tier: one static HTML page.

`GET /dashboard` returns this page verbatim — no templating, no build
step, no external assets.  Everything dynamic happens client-side: a
few lines of inline JavaScript poll the same `/v1` JSON API every
machine client uses (`/v1/query?kind=series&scope=fleet`,
`kind=top_regressions`, `/v1/alerts`) and redraw an inline-SVG fleet
OFU chart, the top-regressions table, and the open-alerts panel.
Because the polls are plain conditional GETs, the browser's cache plus
the server's ETag/304 path make an idle dashboard cost generation-cache
lookups, not rollup readouts — the §II "instant visibility" property
holds for a human watching the page, too.
"""
from __future__ import annotations

DASHBOARD_TITLE = "fleet OFU dashboard"

#: client poll cadence; rollups only move once per collector round, so
#: anything faster just exercises the 304 path
POLL_MS = 5000

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>""" + DASHBOARD_TITLE + """</title>
<style>
  body { font: 14px/1.4 system-ui, sans-serif; margin: 1.5em;
         background: #111; color: #ddd; }
  h1 { font-size: 1.2em; } h2 { font-size: 1em; color: #9ad; }
  .panel { background: #1a1a1a; border: 1px solid #333;
           border-radius: 6px; padding: .8em 1em; margin: .8em 0; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: .2em .6em; }
  th { color: #888; border-bottom: 1px solid #333; }
  .ok { color: #7c7; } .bad { color: #e77; } .dim { color: #777; }
  #headline { font-size: 1.6em; }
  svg { width: 100%; height: 180px; background: #161616; }
</style>
</head>
<body>
<h1>""" + DASHBOARD_TITLE + """ <span id="status" class="dim"></span></h1>
<div class="panel">
  <h2>fleet OFU (weighted: <span id="headline" class="ok">&ndash;</span>)</h2>
  <svg id="chart" viewBox="0 0 600 180" preserveAspectRatio="none"></svg>
  <div class="dim" id="chartmeta"></div>
</div>
<div class="panel">
  <h2>top regressions</h2>
  <table id="regs"><thead><tr><th>job</th><th>factor</th>
    <th>ref OFU</th><th>low OFU</th><th>buckets</th><th>state</th>
  </tr></thead><tbody></tbody></table>
</div>
<div class="panel">
  <h2>alerts (<span id="nalerts">0</span> fired,
      <span id="nopen">0</span> open)</h2>
  <table id="alerts"><thead><tr><th>kind</th><th>job</th>
    <th>detail</th></tr></thead><tbody></tbody></table>
</div>
<script>
"use strict";
const fmt = (x, d) => x == null ? "\\u2013" : Number(x).toFixed(d);

function drawChart(s) {
  const t = s.t_s || [], mean = s.mean || [];
  const pct = s.percentiles || {};
  const lo = pct["10"] || [], hi = pct["90"] || [];
  const svg = document.getElementById("chart");
  if (t.length < 1) { svg.innerHTML = ""; return; }
  const W = 600, H = 180, pad = 6;
  const t0 = t[0], t1 = t[t.length - 1] || t0 + 1;
  const x = v => t1 > t0 ? pad + (W - 2 * pad) * (v - t0) / (t1 - t0)
                         : W / 2;
  const y = v => H - pad - (H - 2 * pad) * Math.min(Math.max(v, 0), 1);
  const path = (ts, vs) => ts.map((tv, i) => vs[i] == null ? "" :
      (i && vs[i - 1] != null ? "L" : "M") +
      x(tv).toFixed(1) + " " + y(vs[i]).toFixed(1)).join(" ");
  let band = "";
  if (lo.length === t.length && hi.length === t.length &&
      lo.every(v => v != null) && hi.every(v => v != null)) {
    const up = t.map((tv, i) => x(tv).toFixed(1) + "," +
                                y(hi[i]).toFixed(1));
    const dn = t.map((tv, i) => x(tv).toFixed(1) + "," +
                                y(lo[i]).toFixed(1)).reverse();
    band = '<polygon points="' + up.concat(dn).join(" ") +
           '" fill="#9ad3" stroke="none"/>';
  }
  svg.innerHTML = band + '<path d="' + path(t, mean) +
      '" fill="none" stroke="#9ad" stroke-width="1.5"/>';
  document.getElementById("chartmeta").textContent =
      t.length + " buckets of " + fmt(s.bucket_s, 0) + "s, mean " +
      "(line) with p10\\u2013p90 band";
}

function drawRegs(r) {
  const body = document.querySelector("#regs tbody");
  body.innerHTML = "";
  for (const g of r.regressions || []) {
    const tr = document.createElement("tr");
    const span = g.end_bucket == null ? g.start_bucket + "\\u2013" :
        g.start_bucket + "\\u2013" + g.end_bucket;
    for (const v of [g.job_id, fmt(g.factor, 2) + "\\u00d7",
                     fmt(g.ref_ofu, 3), fmt(g.low_ofu, 3), span,
                     g.ongoing ? "ONGOING" : "resolved"]) {
      const td = document.createElement("td");
      td.textContent = String(v);
      tr.appendChild(td);
    }
    if (g.ongoing) tr.className = "bad";
    body.appendChild(tr);
  }
}

function drawAlerts(a) {
  document.getElementById("nalerts").textContent = a.total || 0;
  document.getElementById("nopen").textContent =
      (a.active_episodes || []).length;
  const body = document.querySelector("#alerts tbody");
  body.innerHTML = "";
  for (const al of (a.alerts || []).slice(-20).reverse()) {
    const tr = document.createElement("tr");
    for (const v of [al.kind, al.job_id,
                     al.message || JSON.stringify(al)]) {
      const td = document.createElement("td");
      td.textContent = String(v == null ? "\\u2013" : v);
      tr.appendChild(td);
    }
    body.appendChild(tr);
  }
}

async function poll() {
  const st = document.getElementById("status");
  try {
    const [series, regs, alerts] = await Promise.all([
      fetch("/v1/query?kind=series&scope=fleet").then(r => r.json()),
      fetch("/v1/query?kind=top_regressions&k=10").then(r => r.json()),
      fetch("/v1/alerts").then(r => r.json()),
    ]);
    document.getElementById("headline").textContent =
        series.weighted_ofu == null ? "no data yet"
        : (100 * series.weighted_ofu).toFixed(1) + "%";
    drawChart(series);
    drawRegs(regs);
    drawAlerts(alerts);
    st.textContent = "live \\u00b7 gen " + (series.generation ?? "?");
  } catch (e) {
    st.textContent = "unreachable: " + e;
  }
}
poll();
setInterval(poll, """ + str(POLL_MS) + """);
</script>
</body>
</html>
"""
