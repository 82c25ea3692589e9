"""Model registry: named, versioned inference programs for the
multi-tenant fleet.

Counterpart of ``paddle_tpu/serving/registry.py``.  A registered
version IS a ``save_inference_model`` directory — the ProgramDesc JSON
serialization (io.py) is the storage format, so anything the Predictor
can load is registrable and vice versa.  Versions are deduplicated by
PROGRAM FINGERPRINT (core.compiler.program_fingerprint — the compiled
cache's key): registering the same program twice returns the existing
ModelVersion instead of minting a new number, and the rollout
controller uses the same value to assert a rollback restored the exact
old program.

Prewarm (the rollout contract): ``ModelVersion.prewarm`` builds a
Predictor and pushes a zeros batch of every serving bucket through it,
so every bucket's key is warmed up and captured BEFORE the version
takes traffic.  Its Predictors run on the card unless the version's
``configure`` callable (its registry's) changes their
``inference.Config``, e.g. ``Config.disable_gpu``.  A version whose
model cannot load or prewarm surfaces the typed ``PrewarmFailedError``
and takes zero traffic (the old version keeps serving — no partial
fleet).  With the flag ``ir_verify`` on, registration verifies the
saved program and prewarm the Predictor's post-load program
(``analysis.verify``).

Typed errors all subclass ``RegistryError`` (a ``ServingError``), so
fleet callers shed with stable machine-readable codes like every
other serving failure.
"""

from __future__ import annotations

import json
import os
import threading
import time

from paddle_tpu_torch.serving.admission import ServingError

__all__ = ["RegistryError", "ModelNotFoundError",
           "VersionNotFoundError", "PrewarmFailedError",
           "ManifestMismatchError", "ModelVersion", "ModelRegistry"]


class RegistryError(ServingError):
    """Base of typed model-registry failures."""

    code = "registry"


class ModelNotFoundError(RegistryError):
    """No model registered under that name."""

    code = "model_not_found"


class VersionNotFoundError(RegistryError):
    """The model exists but not that version number."""

    code = "version_not_found"


class PrewarmFailedError(RegistryError):
    """The version failed to load or prewarm-compile — it must take
    zero traffic (the rollout controller surfaces this and leaves the
    old version serving)."""

    code = "prewarm_failed"


class ManifestMismatchError(RegistryError):
    """Registry re-adoption found a manifest
    entry whose recorded program fingerprint does not match the
    on-disk ProgramDesc — the model dir was rewritten (or the
    manifest corrupted) since the fleet last ran.  A relaunched fleet
    must not silently serve different bytes under an old version
    number, so adoption fails typed instead."""

    code = "manifest_mismatch"


def _dir_fingerprint(model_dir, model_filename=None):
    """Program fingerprint of a saved inference model WITHOUT running
    its load program (no executor, no params): parse the ProgramDesc
    JSON and hash the reconstructed IR."""
    from paddle_tpu_torch.core.compiler import program_fingerprint
    from paddle_tpu_torch.core.program import Program

    path = os.path.join(model_dir, model_filename or "__model__")
    try:
        with open(path) as f:
            meta = json.load(f)
        program = Program.from_dict(meta["program"])
    except (OSError, ValueError, KeyError) as e:
        raise RegistryError(
            f"cannot read inference model at {model_dir!r}: "
            f"{type(e).__name__}: {e}") from e
    # with ir_verify on, a malformed program is refused AT
    # REGISTRATION (typed, naming block/op/var) instead of surfacing
    # as a prewarm compile failure — or worse, serving garbage.  The
    # declared feed/fetch targets are part of the checked contract.
    from paddle_tpu_torch.analysis.passes import verify_enabled

    if verify_enabled():
        from paddle_tpu_torch.analysis import VerifierError, verify

        try:
            verify(program,
                   feeds=meta.get("feed_names") or (),
                   fetches=meta.get("fetch_names") or (),
                   roundtrip=True, label=f"register:{model_dir}")
        except VerifierError as e:
            raise RegistryError(
                f"refusing malformed inference model at "
                f"{model_dir!r}: {e}") from e
    return program_fingerprint(program)


class ModelVersion:
    """One immutable (name, version) entry: a model dir + its program
    fingerprint."""

    __slots__ = ("name", "version", "model_dir", "fingerprint",
                 "registered_t", "prewarmed", "serving_fingerprint",
                 "configure")

    def __init__(self, name, version, model_dir, fingerprint,
                 configure=None):
        self.name = str(name)
        self.version = int(version)
        self.model_dir = str(model_dir)
        # fingerprint of the SERIALIZED program (dedupe key: what is
        # on disk).  serving_fingerprint is the fingerprint AFTER the
        # predictor's load pipeline (ir_optim fusions mutate the IR),
        # i.e. what a serving replica actually reports — recorded at
        # first prewarm; the rollout controller converges on it.
        self.fingerprint = fingerprint
        self.serving_fingerprint = None
        self.registered_t = time.time()
        self.prewarmed = False
        # configure(config) edits each Predictor's inference.Config
        # before the load (None: the defaults, on the card)
        self.configure = configure

    def __repr__(self):
        return f"{self.name}@v{self.version}"

    def to_dict(self):
        return {"name": self.name, "version": self.version,
                "model_dir": self.model_dir,
                "fingerprint": self.fingerprint,
                "serving_fingerprint": self.serving_fingerprint,
                "registered_t": self.registered_t,
                "prewarmed": self.prewarmed}

    def make_predictor(self):
        """Load a fresh Predictor of this version (private scope +
        compiled cache, like any replica predictor), its
        ``inference.Config`` edited by ``configure`` first.  Load
        failures surface as the typed PrewarmFailedError."""
        from paddle_tpu_torch import inference

        try:
            config = inference.Config(self.model_dir)
            if self.configure is not None:
                self.configure(config)
            return inference.create_predictor(config)
        except Exception as e:
            raise PrewarmFailedError(
                f"{self}: predictor load failed: "
                f"{type(e).__name__}: {e}") from e

    def prewarm(self, buckets=(1, 2, 4, 8), predictor=None):
        """Warm up and capture every serving bucket BEFORE the version
        takes traffic: a zeros batch per bucket through the predictor
        (the server-prewarm shape).  Returns the warmed predictor;
        raises the typed PrewarmFailedError on any load/run failure."""
        import numpy as np

        p = predictor if predictor is not None \
            else self.make_predictor()
        # re-verify the post-load IR (ir_optim fusions have run by now)
        # BEFORE spending warm-up and capture on it — a pass that broke
        # the IR at load time surfaces typed here, not as an opaque
        # failure mid-prewarm
        from paddle_tpu_torch.analysis.passes import verify_enabled

        if verify_enabled():
            from paddle_tpu_torch.analysis import VerifierError, verify

            try:
                verify(p._program, label=f"prewarm:{self}")
            except VerifierError as e:
                raise PrewarmFailedError(
                    f"{self}: post-load IR failed verification: "
                    f"{e}") from e
        try:
            specs = p.feed_specs()
            for b in buckets:
                feeds = [np.zeros((int(b),) + tuple(
                    int(d) for d in shape[1:]), dtype=dtype)
                    for shape, dtype in specs.values()]
                p.run(feeds)
        except PrewarmFailedError:
            raise
        except Exception as e:
            raise PrewarmFailedError(
                f"{self}: prewarm compile failed: "
                f"{type(e).__name__}: {e}") from e
        self.prewarmed = True
        self.serving_fingerprint = p.program_fingerprint()
        return p


class ModelRegistry:
    """Named, versioned programs for the serving fleet.

    ``register(name, model_dir)`` adopts an existing
    ``save_inference_model`` directory; ``register_program(...)``
    serializes a live program into the registry root first (the same
    io.save_inference_model path).  Version numbers are monotonic per
    name starting at 1; re-registering a program whose fingerprint the
    name already holds is a NO-OP returning the existing version
    (dedupe — rollout to "the same bytes" is a no-op by construction).
    ``configure`` becomes every version's ``ModelVersion.configure``
    (e.g. ``lambda c: c.disable_gpu()`` to serve on the CPU).
    """

    MANIFEST = "REGISTRY_MANIFEST.json"

    def __init__(self, root=None, configure=None):
        self.root = root
        self.configure = configure
        self._models: dict = {}       # name -> [ModelVersion]
        self._lock = threading.Lock()
        # persistence across restarts: a registry built over a root
        # dir RE-ADOPTS the versions its manifest recorded, so a
        # relaunched fleet recovers its catalog without re-registering
        # — each adopted dir's ProgramDesc is re-fingerprinted and
        # must match the manifest (typed ManifestMismatchError
        # otherwise: never silently serve different bytes under an
        # old version number)
        self.adopted = 0
        if root is not None:
            self.adopted = self._adopt_manifest()

    # -- persistence --------------------------------------------------------
    def _manifest_path(self):
        return os.path.join(self.root, self.MANIFEST)

    def _write_manifest_locked(self):
        """Serialize the catalog (atomic rename — a crash mid-write
        must never leave a half manifest for the next launch)."""
        if self.root is None:
            return
        os.makedirs(self.root, exist_ok=True)
        data = {"models": {n: [v.to_dict() for v in vs]
                           for n, vs in self._models.items()}}
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, self._manifest_path())

    def _adopt_manifest(self):
        """Re-adopt every manifest entry, verifying each model dir's
        on-disk ProgramDesc still hashes to the recorded fingerprint.
        Returns the number of versions adopted (0 when no manifest
        exists — a fresh root)."""
        path = self._manifest_path()
        if not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                data = json.load(f)
            models = data["models"]
        except (OSError, ValueError, KeyError) as e:
            raise RegistryError(
                f"cannot read registry manifest at {path!r}: "
                f"{type(e).__name__}: {e}") from e
        n = 0
        for name, entries in sorted(models.items()):
            versions = []
            for ent in sorted(entries, key=lambda e: e["version"]):
                fp = _dir_fingerprint(ent["model_dir"])
                if str(fp) != str(ent["fingerprint"]):
                    raise ManifestMismatchError(
                        "%s@v%s: on-disk ProgramDesc fingerprint %s "
                        "!= manifest fingerprint %s (model dir %r "
                        "rewritten since the manifest was banked)"
                        % (name, ent["version"], fp,
                           ent["fingerprint"], ent["model_dir"]))
                v = ModelVersion(name, ent["version"],
                                 ent["model_dir"], fp, self.configure)
                v.registered_t = ent.get("registered_t",
                                         v.registered_t)
                # prewarm state is NOT adopted: a relaunched process
                # has captured nothing yet; serving_fingerprint rides
                # along as a hint for convergence checks
                v.serving_fingerprint = ent.get("serving_fingerprint")
                versions.append(v)
                n += 1
            if versions:
                self._models[str(name)] = versions
        from paddle_tpu_torch.observability import \
            flight_recorder as _flight

        _flight.record("fleet", "registry_adopted",
                       root=str(self.root), versions=n)
        return n

    # -- registration -------------------------------------------------------
    def register(self, name, model_dir, model_filename=None):
        """Register a saved inference model dir as the next version of
        ``name`` (or return the existing version with the same program
        fingerprint).  With a registry root, the manifest persists the
        catalog for re-adoption after a restart."""
        fp = _dir_fingerprint(model_dir, model_filename)
        with self._lock:
            versions = self._models.setdefault(str(name), [])
            for v in versions:
                if v.fingerprint == fp:
                    return v              # dedupe by fingerprint
            v = ModelVersion(name, len(versions) + 1, model_dir, fp,
                             self.configure)
            versions.append(v)
            self._write_manifest_locked()
        from paddle_tpu_torch.observability import \
            flight_recorder as _flight

        _flight.record("fleet", "version_registered", model=str(name),
                       version=v.version, fingerprint=str(fp))
        return v

    def register_program(self, name, feed_names, target_vars,
                         executor, main_program=None):
        """Serialize a live program (io.save_inference_model — the
        ProgramDesc path) into ``root/name/v<N>`` and register it."""
        if self.root is None:
            raise RegistryError(
                "register_program needs a registry root dir "
                "(ModelRegistry(root=...))")
        from paddle_tpu_torch import io

        with self._lock:
            n = len(self._models.get(str(name), ())) + 1
        d = os.path.join(self.root, str(name), "v%d" % n)
        io.save_inference_model(d, feed_names, target_vars, executor,
                                main_program=main_program)
        return self.register(name, d)

    # -- lookup -------------------------------------------------------------
    def models(self):
        with self._lock:
            return sorted(self._models)

    def versions(self, name):
        with self._lock:
            vs = self._models.get(str(name))
            if vs is None:
                raise ModelNotFoundError(
                    f"no model registered as {name!r} "
                    f"(have: {sorted(self._models)})")
            return list(vs)

    def get(self, name, version=None):
        """A specific version, or the latest when ``version`` is
        None."""
        vs = self.versions(name)
        if version is None:
            return vs[-1]
        for v in vs:
            if v.version == int(version):
                return v
        raise VersionNotFoundError(
            f"{name!r} has no version {version} "
            f"(have: {[v.version for v in vs]})")

    latest = get

    def find_by_fingerprint(self, name, fingerprint):
        for v in self.versions(name):
            if v.fingerprint == fingerprint:
                return v
        return None

    def save(self):
        """Re-bank the manifest now (e.g. after a prewarm recorded a
        serving_fingerprint worth persisting).  No-op without a
        root."""
        with self._lock:
            self._write_manifest_locked()

    def to_dict(self):
        with self._lock:
            return {n: [v.to_dict() for v in vs]
                    for n, vs in self._models.items()}
