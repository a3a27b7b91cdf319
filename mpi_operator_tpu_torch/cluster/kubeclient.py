"""Real-cluster backend: a typed Kubernetes REST client on the stdlib.

The reference builds its clientsets from a kubeconfig or in-cluster config
(cmd/mpi-operator/main.go:42-96) and talks to the API server through
machine-generated typed clients
(pkg/client/clientset/versioned/typed/kubeflow/v1alpha1/mpijob.go:37-48 —
Create/Update/UpdateStatus/Delete/Get/List/Watch). This module is the
hand-rolled TPU-build equivalent, with zero third-party dependencies
(urllib + ssl + json + yaml): the `kubernetes` pip package is deliberately
NOT required.

Three pieces:
  - `KubeConfig`    — connection info from a kubeconfig file
                      (`--kube-config`), an explicit `--master` URL, or the
                      in-cluster service-account mount.
  - `KubeAPIServer` — implements the exact verb surface of
                      `InMemoryAPIServer` (create/update/update_status/get/
                      try_get/list/delete/watch/register_admission_validator),
                      so `TPUJobController` runs unchanged against a real
                      cluster. Objects cross the boundary through
                      `serialize.to_manifest`/`from_manifest`.
  - watch threads   — one daemon thread per watched kind running the
                      list-then-watch loop (the informer Reflector pattern,
                      ref pkg/client/informers/.../mpijob.go:34-87), with
                      bookmark-free resourceVersion resume and re-list on
                      410 Gone.
"""
from __future__ import annotations

import base64
import json
import logging
import os
import ssl
import tempfile
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional

from .apiserver import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    NotFoundError,
)
from .serialize import API_RESOURCES, from_manifest, to_manifest

logger = logging.getLogger("kubeclient")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


# ---------------------------------------------------------------------------
# connection config
# ---------------------------------------------------------------------------

class KubeConfigError(Exception):
    pass


class KubeConfig:
    """Server address + credentials. ref: clientcmd.BuildConfigFromFlags
    (cmd/mpi-operator/main.go:48) resolves master/kubeconfig/in-cluster in
    the same precedence order `load` implements."""

    def __init__(self, server: str, token: Optional[str] = None,
                 ca_data: Optional[bytes] = None,
                 client_cert_data: Optional[bytes] = None,
                 client_key_data: Optional[bytes] = None,
                 insecure_skip_tls_verify: bool = False):
        self.server = server.rstrip("/")
        self.token = token
        self.ca_data = ca_data
        self.client_cert_data = client_cert_data
        self.client_key_data = client_key_data
        self.insecure_skip_tls_verify = insecure_skip_tls_verify
        self._certfiles: List[str] = []

    # -- loaders ------------------------------------------------------------

    @classmethod
    def load(cls, kubeconfig: str = "", master: str = "") -> "KubeConfig":
        """Precedence mirrors the reference: explicit flags first, else the
        in-cluster environment (main.go:48 falls back the same way)."""
        if kubeconfig:
            cfg = cls.from_kubeconfig(kubeconfig)
            if master:
                cfg.server = master.rstrip("/")
            return cfg
        if master:
            return cls(server=master)
        return cls.in_cluster()

    @classmethod
    def from_kubeconfig(cls, path: str,
                        context: Optional[str] = None) -> "KubeConfig":
        import yaml  # baked into the environment (PyYAML)
        with open(path) as f:
            doc = yaml.safe_load(f)

        def by_name(section, name):
            for item in doc.get(section) or []:
                if item.get("name") == name:
                    return item.get(section[:-1], {})
            raise KubeConfigError(f"{section[:-1]} {name!r} not in {path}")

        ctx_name = context or doc.get("current-context")
        if not ctx_name:
            raise KubeConfigError(f"no current-context in {path}")
        ctx = by_name("contexts", ctx_name)
        cluster = by_name("clusters", ctx["cluster"])
        user = by_name("users", ctx["user"]) if ctx.get("user") else {}

        def b64field(section, key):
            data = section.get(key + "-data")
            if data:
                return base64.b64decode(data)
            fname = section.get(key)
            if fname and os.path.exists(fname):
                with open(fname, "rb") as fh:
                    return fh.read()
            return None

        token = user.get("token")
        if not token and user.get("auth-provider"):
            token = (user["auth-provider"].get("config") or {}).get(
                "access-token")

        return cls(
            server=cluster["server"],
            token=token,
            ca_data=b64field(cluster, "certificate-authority"),
            client_cert_data=b64field(user, "client-certificate"),
            client_key_data=b64field(user, "client-key"),
            insecure_skip_tls_verify=bool(
                cluster.get("insecure-skip-tls-verify", False)),
        )

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise KubeConfigError(
                "not running in a cluster (KUBERNETES_SERVICE_HOST unset) "
                "and no --kube-config/--master given")
        token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
        with open(token_path) as f:
            token = f.read().strip()
        ca_data = None
        if os.path.exists(ca_path):
            with open(ca_path, "rb") as f:
                ca_data = f.read()
        return cls(server=f"https://{host}:{port}", token=token,
                   ca_data=ca_data)

    @staticmethod
    def namespace_in_cluster() -> Optional[str]:
        ns_path = os.path.join(SERVICE_ACCOUNT_DIR, "namespace")
        if os.path.exists(ns_path):
            with open(ns_path) as f:
                return f.read().strip()
        return None

    # -- ssl ----------------------------------------------------------------

    def cleanup(self) -> None:
        """Remove client-cert material written for ssl (private key!)."""
        for path in self._certfiles:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._certfiles = []

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        ctx = ssl.create_default_context()
        if self.insecure_skip_tls_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.ca_data:
            ctx.load_verify_locations(cadata=self.ca_data.decode())
        if self.client_cert_data and self.client_key_data:
            # ssl only loads client certs from files; write once per config.
            cert = tempfile.NamedTemporaryFile("wb", suffix=".pem",
                                               delete=False)
            cert.write(self.client_cert_data)
            cert.close()
            key = tempfile.NamedTemporaryFile("wb", suffix=".pem",
                                              delete=False)
            key.write(self.client_key_data)
            key.close()
            os.chmod(key.name, 0o600)
            self._certfiles += [cert.name, key.name]
            ctx.load_cert_chain(cert.name, key.name)
            # the context has read the files; the key must not outlive us
            import atexit
            atexit.register(self.cleanup)
        return ctx


# ---------------------------------------------------------------------------
# REST plumbing
# ---------------------------------------------------------------------------

def _resource_path(kind: str, namespace: Optional[str], name: str = "",
                   subresource: str = "") -> str:
    """REST path for a kind: namespaced when `namespace` is given, the
    cluster-wide collection otherwise (list/watch across namespaces)."""
    api_version, plural = API_RESOURCES[kind]
    prefix = (f"/apis/{api_version}" if "/" in api_version
              else f"/api/{api_version}")
    path = (f"{prefix}/namespaces/{namespace}/{plural}" if namespace
            else f"{prefix}/{plural}")
    if name:
        path += f"/{name}"
    if subresource:
        path += f"/{subresource}"
    return path


class KubeAPIServer:
    """`InMemoryAPIServer`-shaped adapter over a real API server.

    The controller is constructed with either backend and cannot tell them
    apart — the seam the reference gets from its clientset interface
    (mpijob.go:37-48) — except that here admission is double-checked
    client-side (the cluster's CRD schema, deploy/0-crd.yaml, is the real
    gate)."""

    def __init__(self, config: KubeConfig, request_timeout: float = 30.0,
                 watch_timeout_seconds: int = 300):
        self.config = config
        self.request_timeout = request_timeout
        self.watch_timeout_seconds = watch_timeout_seconds
        self._ssl = config.ssl_context()
        self._admission: Dict[str, Callable[[object], None]] = {}
        self._watch_threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- HTTP ---------------------------------------------------------------

    def _headers(self) -> Dict[str, str]:
        h = {"Accept": "application/json",
             "Content-Type": "application/json"}
        if self.config.token:
            h["Authorization"] = f"Bearer {self.config.token}"
        return h

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 query: Optional[dict] = None, timeout: Optional[float] = None,
                 stream: bool = False):
        url = self.config.server + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=self._headers())
        try:
            resp = urllib.request.urlopen(
                req, timeout=timeout or self.request_timeout,
                context=self._ssl)
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode(errors="replace")
            except Exception:  # noqa: BLE001
                pass
            raise self._typed_error(e.code, method, path, detail) from e
        if stream:
            return resp
        with resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    @staticmethod
    def _typed_error(code: int, method: str, path: str,
                     detail: str) -> ApiError:
        # surface the server's Status message when it parses
        msg = detail
        try:
            msg = json.loads(detail).get("message", detail)
        except (ValueError, AttributeError):
            pass
        kind_name = path.rsplit("/", 1)[-1]
        if code == 404:
            return NotFoundError("", kind_name)
        if code == 409:
            if method == "POST":
                return AlreadyExistsError("", kind_name)
            return ConflictError("", kind_name, msg)
        if code == 410:
            return ApiError("Gone", msg)
        if code in (400, 422):
            return ApiError("Invalid", f"{method} {path}: {msg}")
        if code in (401, 403):
            return ApiError("Forbidden", f"{method} {path}: {msg}")
        return ApiError("ServerError", f"{method} {path}: HTTP {code} {msg}")

    # -- admission (interface parity; a real cluster re-validates via the
    #    CRD structural schema, deploy/0-crd.yaml) ---------------------------

    def register_admission_validator(self, kind, validator) -> None:
        self._admission[kind] = validator

    def _admit(self, obj) -> None:
        validator = self._admission.get(obj.kind)
        if validator is not None:
            try:
                validator(obj)
            except Exception as exc:  # noqa: BLE001 — wrap into typed error
                raise ApiError(
                    "Invalid",
                    f"{obj.kind} admission denied: {exc}") from exc

    # -- CRUD (ref clientset verbs, mpijob.go:37-48) ------------------------

    def create(self, obj):
        self._admit(obj)
        path = _resource_path(obj.kind, obj.metadata.namespace)
        manifest = to_manifest(obj)
        manifest["metadata"].pop("resourceVersion", None)
        got = self._request("POST", path, body=manifest)
        return from_manifest(got)

    def update(self, obj, *, subresource: Optional[str] = None):
        self._admit(obj)
        path = _resource_path(obj.kind, obj.metadata.namespace,
                              obj.metadata.name, subresource or "")
        got = self._request("PUT", path, body=to_manifest(obj))
        return from_manifest(got)

    def update_status(self, obj):
        """ref: UpdateStatus (mpijob.go:41) — the /status subresource."""
        return self.update(obj, subresource="status")

    def get(self, kind: str, namespace: str, name: str):
        path = _resource_path(kind, namespace, name)
        try:
            got = self._request("GET", path)
        except NotFoundError:
            raise NotFoundError(kind, f"{namespace}/{name}") from None
        return self._post(from_manifest(got))

    # -- Job exit-code enrichment -------------------------------------------

    def _post(self, obj):
        """batch/v1 JobStatus carries no container exit code, but the
        ExitCode gang-restart policy (v1alpha2 common_types.go:150-155)
        decides on it — so a failed launcher Job is enriched from its pods'
        containerStatuses before the controller sees it."""
        if (obj.kind == "Job" and obj.status.failed > 0
                and obj.status.exit_code is None):
            obj.status.exit_code = self._lookup_exit_code(obj)
        return obj

    def _lookup_exit_code(self, job_obj) -> Optional[int]:
        try:
            got = self._request(
                "GET", _resource_path("Pod", job_obj.metadata.namespace),
                query={"labelSelector":
                       f"job-name={job_obj.metadata.name}"})
        except ApiError as e:
            logger.warning("pod lookup for %s failed: %s",
                           job_obj.metadata.name, e)
            return None
        for item in got.get("items") or []:
            # one canonical containerStatuses parser (serialize.Pod):
            # first non-zero terminated exitCode wins
            item.setdefault("kind", "Pod")
            pod = from_manifest(item)
            if pod.status.exit_code:
                return pod.status.exit_code
        return None

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[str] = None):
        objs, _ = self._list_with_rv(kind, namespace,
                                     label_selector=label_selector)
        return objs

    def _list_with_rv(self, kind: str, namespace: Optional[str],
                      label_selector: Optional[str] = None):
        query = ({"labelSelector": label_selector}
                 if label_selector else None)
        got = self._request("GET", _resource_path(kind, namespace),
                            query=query)
        rv = (got.get("metadata") or {}).get("resourceVersion", "")
        items = []
        for item in got.get("items") or []:
            item.setdefault("kind", kind)
            items.append(self._post(from_manifest(item)))
        return items, rv

    def delete(self, kind: str, namespace: str, name: str) -> None:
        path = _resource_path(kind, namespace, name)
        # propagationPolicy=Background: batch/v1 Job deletes default to
        # ORPHANING dependents on a real API server, so the resize path's
        # launcher-Job delete would leave the old launcher pod running with
        # the stale topology env while the new launcher is created
        body = {"kind": "DeleteOptions", "apiVersion": "v1",
                "propagationPolicy": "Background"}
        try:
            self._request("DELETE", path, body=body)
        except NotFoundError:
            raise NotFoundError(kind, f"{namespace}/{name}") from None

    # -- watch (Reflector: list → watch → resume/re-list) -------------------

    def watch(self, kind: str, handler, namespace: Optional[str] = None):
        """Spawn a daemon list-watch thread dispatching
        handler(event_type, obj, old_obj) — the same callback contract the
        informers consume from InMemoryAPIServer.watch."""
        t = threading.Thread(
            target=self._watch_loop, args=(kind, handler, namespace),
            name=f"watch-{kind}", daemon=True)
        self._watch_threads.append(t)
        t.start()

    def _watch_loop(self, kind: str, handler, namespace: Optional[str]):
        # local cache so MODIFIED events can hand the previous object to the
        # informer (RV resync-skip contract, informers.py)
        cache: Dict[tuple, object] = {}
        rv = ""
        while not self._stop.is_set():
            try:
                if not rv:
                    objs, rv = self._list_with_rv(kind, namespace)
                    fresh = {}
                    for obj in objs:
                        key = (obj.metadata.namespace, obj.metadata.name)
                        old = cache.get(key)
                        fresh[key] = obj
                        if old is None:
                            handler("ADDED", obj, None)
                        elif (old.metadata.resource_version
                              != obj.metadata.resource_version):
                            handler("MODIFIED", obj, old)
                    for key, old in cache.items():
                        if key not in fresh:
                            handler("DELETED", old, None)
                    cache = fresh
                rv = self._watch_once(kind, namespace, rv, cache, handler)
            except ApiError as e:
                if e.reason == "Gone":      # 410: RV too old → re-list
                    rv = ""
                    continue
                logger.warning("watch %s failed: %s; retrying", kind, e)
                self._stop.wait(1.0)
                rv = ""
            except Exception as e:  # noqa: BLE001 — network hiccups
                if self._stop.is_set():
                    return
                logger.warning("watch %s error: %s; retrying", kind, e)
                self._stop.wait(1.0)
                rv = ""

    def _watch_once(self, kind: str, namespace: Optional[str], rv: str,
                    cache: Dict[tuple, object], handler) -> str:
        path = _resource_path(kind, namespace)
        resp = self._request(
            "GET", path,
            query={"watch": "true", "resourceVersion": rv,
                   "timeoutSeconds": str(self.watch_timeout_seconds),
                   "allowWatchBookmarks": "true"},
            timeout=self.watch_timeout_seconds + 15, stream=True)
        with resp:
            for line in resp:
                if self._stop.is_set():
                    return rv
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                etype = event.get("type")
                manifest = event.get("object") or {}
                if etype == "BOOKMARK":
                    rv = (manifest.get("metadata") or {}).get(
                        "resourceVersion", rv)
                    continue
                if etype == "ERROR":
                    code = (manifest.get("code") or 0)
                    if code == 410:
                        raise ApiError("Gone", manifest.get("message", ""))
                    raise ApiError("WatchError",
                                   manifest.get("message", str(manifest)))
                manifest.setdefault("kind", kind)
                obj = self._post(from_manifest(manifest))
                rv = str(obj.metadata.resource_version) or rv
                key = (obj.metadata.namespace, obj.metadata.name)
                if etype == "ADDED":
                    cache[key] = obj
                    handler("ADDED", obj, None)
                elif etype == "MODIFIED":
                    old = cache.get(key)
                    cache[key] = obj
                    handler("MODIFIED", obj, old)
                elif etype == "DELETED":
                    cache.pop(key, None)
                    handler("DELETED", obj, None)
        return rv

    def stop(self) -> None:
        self._stop.set()
        self.config.cleanup()


__all__ = ["KubeConfig", "KubeConfigError", "KubeAPIServer"]
