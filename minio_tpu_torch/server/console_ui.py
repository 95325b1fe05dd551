"""Embedded browser console (the reference ships a React bundle via
cmd/web-router.go + assets; here one self-contained page, no build
step, driving the same web JSON-RPC plane).

Served at GET /minio-tpu/console.  Pure static text - no templating,
no user input interpolation server-side.
"""

CONSOLE_HTML = b"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>minio-tpu console</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
  :root { --fg: #1a1f29; --mut: #69707d; --line: #e3e6ea;
          --acc: #0a6fb8; --bad: #b02a37; --bg: #f7f8fa; }
  * { box-sizing: border-box; }
  body { margin: 0; font: 14px/1.45 system-ui, sans-serif;
         color: var(--fg); background: var(--bg); }
  header { background: #fff; border-bottom: 1px solid var(--line);
           padding: 10px 20px; display: flex; align-items: center;
           justify-content: space-between; }
  header h1 { font-size: 16px; margin: 0; }
  main { max-width: 960px; margin: 24px auto; padding: 0 16px; }
  .card { background: #fff; border: 1px solid var(--line);
          border-radius: 6px; padding: 16px; margin-bottom: 16px; }
  table { width: 100%; border-collapse: collapse; }
  th, td { text-align: left; padding: 6px 8px;
           border-bottom: 1px solid var(--line); }
  th { color: var(--mut); font-weight: 600; font-size: 12px;
       text-transform: uppercase; }
  a { color: var(--acc); text-decoration: none; cursor: pointer; }
  button { border: 1px solid var(--line); background: #fff;
           border-radius: 4px; padding: 5px 10px; cursor: pointer; }
  button.primary { background: var(--acc); color: #fff;
                   border-color: var(--acc); }
  button.danger { color: var(--bad); }
  input { border: 1px solid var(--line); border-radius: 4px;
          padding: 6px 8px; }
  #err { color: var(--bad); min-height: 1.2em; margin: 8px 0; }
  .row { display: flex; gap: 8px; align-items: center;
         flex-wrap: wrap; }
  .crumb { margin: 0 0 10px; color: var(--mut); }
  .hidden { display: none; }
</style>
</head>
<body>
<header>
  <h1>minio-tpu console</h1>
  <div id="who" class="row"></div>
</header>
<main>
  <div id="err"></div>
  <div id="login" class="card">
    <h3>Sign in</h3>
    <div class="row">
      <input id="user" placeholder="access key" autocomplete="username">
      <input id="pass" placeholder="secret key" type="password"
             autocomplete="current-password">
      <button class="primary" onclick="login()">Sign in</button>
    </div>
  </div>
  <div id="app" class="hidden">
    <div class="card">
      <div class="row">
        <h3 style="margin:0;flex:1">Buckets</h3>
        <input id="newbucket" placeholder="new bucket name">
        <button class="primary" onclick="makeBucket()">Create</button>
      </div>
      <table><tbody id="buckets"></tbody></table>
    </div>
    <div id="objects-card" class="card hidden">
      <p class="crumb" id="crumb"></p>
      <div class="row" style="margin-bottom:10px">
        <input id="file" type="file">
        <button class="primary" onclick="upload()">Upload</button>
      </div>
      <table>
        <thead><tr><th>Key</th><th>Size</th><th></th></tr></thead>
        <tbody id="objects"></tbody>
      </table>
    </div>
  </div>
</main>
<script>
"use strict";
let token = sessionStorage.getItem("mt-token") || "";
let bucket = "", prefix = "";
const $ = id => document.getElementById(id);
// rows are built with DOM APIs + addEventListener, never by
// interpolating names into HTML/JS strings: object keys are
// user-controlled and must stay inert text
function el(tag, text) {
  const e = document.createElement(tag);
  if (text !== undefined) e.textContent = text;
  return e;
}
function actionLink(label, fn, cls) {
  const b = el(cls === "link" ? "a" : "button", label);
  if (cls && cls !== "link") b.className = cls;
  b.addEventListener("click", fn);
  return b;
}

async function rpc(method, params) {
  const headers = {"Content-Type": "application/json"};
  if (token) headers["Authorization"] = "Bearer " + token;
  const r = await fetch("/minio-tpu/webrpc", {
    method: "POST", headers,
    body: JSON.stringify({id: 1, jsonrpc: "2.0", method,
                          params: params || {}}),
  });
  const doc = await r.json();
  if (doc.error) throw new Error(doc.error.message);
  return doc.result;
}
function fail(e) { $("err").textContent = e.message || String(e); }
function ok() { $("err").textContent = ""; }

async function login() {
  try {
    const res = await rpc("web.Login", {
      username: $("user").value, password: $("pass").value});
    token = res.token;
    sessionStorage.setItem("mt-token", token);
    ok(); show();
  } catch (e) { fail(e); }
}
function logout() {
  token = ""; sessionStorage.removeItem("mt-token");
  location.reload();
}
async function show() {
  $("login").classList.add("hidden");
  $("app").classList.remove("hidden");
  $("who").innerHTML = '<button onclick="logout()">Sign out</button>';
  await listBuckets();
}
async function listBuckets() {
  try {
    const res = await rpc("web.ListBuckets");
    const tbody = $("buckets");
    tbody.replaceChildren();
    if (!res.buckets.length) {
      const tr = el("tr");
      tr.append(el("td", "no buckets"));
      tbody.append(tr);
    }
    for (const b of res.buckets) {
      const tr = el("tr");
      const td1 = el("td");
      td1.append(actionLink(b.name, () => openBucket(b.name), "link"));
      const td2 = el("td");
      td2.style.textAlign = "right";
      td2.append(actionLink("delete", () => dropBucket(b.name),
                            "danger"));
      tr.append(td1, td2);
      tbody.append(tr);
    }
    ok();
  } catch (e) { fail(e); }
}
async function makeBucket() {
  try {
    await rpc("web.MakeBucket", {bucketName: $("newbucket").value});
    $("newbucket").value = ""; await listBuckets();
  } catch (e) { fail(e); }
}
async function dropBucket(name) {
  if (!confirm("Delete bucket " + name + "?")) return;
  try {
    await rpc("web.DeleteBucket", {bucketName: name});
    if (bucket === name) $("objects-card").classList.add("hidden");
    await listBuckets();
  } catch (e) { fail(e); }
}
async function openBucket(name, pfx) {
  bucket = name; prefix = pfx || "";
  try {
    const res = await rpc("web.ListObjects",
                          {bucketName: bucket, prefix});
    $("objects-card").classList.remove("hidden");
    $("crumb").textContent = bucket + "/" + prefix;
    const tbody = $("objects");
    tbody.replaceChildren();
    if (!res.objects.length) {
      const tr = el("tr");
      tr.append(el("td", "empty"));
      tbody.append(tr);
    }
    for (const o of res.objects) {
      const tr = el("tr");
      if (o.isDir) {
        const td = el("td");
        td.append(actionLink(o.name,
          () => openBucket(bucket, o.name), "link"));
        tr.append(td, el("td"), el("td"));
      } else {
        const td3 = el("td");
        td3.style.textAlign = "right";
        td3.append(actionLink("download", () => download(o.name),
                              "link"));
        td3.append(document.createTextNode(" "));
        td3.append(actionLink("delete", () => removeObj(o.name),
                              "danger"));
        tr.append(el("td", o.name), el("td", String(o.size)), td3);
      }
      tbody.append(tr);
    }
    ok();
  } catch (e) { fail(e); }
}
async function removeObj(key) {
  try {
    await rpc("web.RemoveObject",
              {bucketName: bucket, objects: [key]});
    await openBucket(bucket, prefix);
  } catch (e) { fail(e); }
}
async function download(key) {
  try {
    const res = await rpc("web.CreateURLToken");
    location.href = "/minio-tpu/web/download/" + bucket + "/" +
      encodeURIComponent(key).replaceAll("%2F", "/") +
      "?token=" + encodeURIComponent(res.token);
  } catch (e) { fail(e); }
}
async function upload() {
  const f = $("file").files[0];
  if (!f) { fail(new Error("choose a file first")); return; }
  try {
    const encPrefix = prefix.split("/").map(
      encodeURIComponent).join("/");
    const r = await fetch("/minio-tpu/web/upload/" +
        encodeURIComponent(bucket) + "/" +
        encPrefix + encodeURIComponent(f.name), {
      method: "PUT",
      headers: {"Authorization": "Bearer " + token,
                "Content-Type": f.type || "application/octet-stream"},
      body: f,
    });
    if (!r.ok) throw new Error("upload failed: HTTP " + r.status);
    $("file").value = "";
    await openBucket(bucket, prefix);
  } catch (e) { fail(e); }
}
if (token) show();
</script>
</body>
</html>
"""
