"""Gallery-artifact staleness manifest (VERDICT r3 item 8).

Committed gallery renders are validated by tests that compare artifacts
against the reference goldens — but a committed PNG keeps passing even
after a kernel change shifts radiance, until someone remembers to
re-render. The manifest closes that hole: every artifact records the
digest of the RENDER-DETERMINING sources at render time, and a test
fails when those sources changed without regenerating the artifact.

The digest covers exactly the files whose code determines pixel values
(kernel math, scene construction, camera derivation, sampling, image
quantization) — NOT scheduling/test/CLI files, so perf-only refactors
(tile sizes, pass counts, compaction) that are bit-identical by
construction still require no re-render only if they truly don't touch
these files; when in doubt the test errs on re-rendering.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys

# Files whose content determines rendered pixel values. Paths relative
# to the repo root.
RENDER_SOURCES = (
    "ray_tracing_in_one_weekend_tpu/ops/pallas_render.py",
    "ray_tracing_in_one_weekend_tpu/ops/render.py",
    "ray_tracing_in_one_weekend_tpu/ops/integrator.py",
    "ray_tracing_in_one_weekend_tpu/ops/intersect.py",
    "ray_tracing_in_one_weekend_tpu/ops/materials.py",
    "ray_tracing_in_one_weekend_tpu/ops/sampling.py",
    "ray_tracing_in_one_weekend_tpu/ops/vecmath.py",
    "ray_tracing_in_one_weekend_tpu/ops/image.py",
    "ray_tracing_in_one_weekend_tpu/models/scene.py",
    "ray_tracing_in_one_weekend_tpu/models/camera.py",
)

MANIFEST_NAME = "MANIFEST.json"


def repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    """Remove docstring expressions so the digest tracks CODE."""
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (
            isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            node.body = body[1:] or [ast.Pass()]
    return tree


def render_sources_digest(root: str | None = None) -> str:
    """sha256 over the render-determining sources' ASTs.

    Hashing docstring-stripped, re-unparsed source (not raw bytes)
    makes the digest insensitive to comment/docstring churn —
    documentation edits in kernel files must not demand a gallery
    re-render — while any executable-code change (even a constant)
    still changes it. `ast.unparse` (canonical source) is used instead
    of `ast.dump` because dump's field inventory changes across Python
    minor versions, which would falsely mark artifacts stale when the
    render and CI interpreters differ.
    """
    root = root or repo_root()
    h = hashlib.sha256()
    for rel in RENDER_SOURCES:
        h.update(rel.encode())
        with open(os.path.join(root, rel)) as f:
            tree = _strip_docstrings(ast.parse(f.read()))
        h.update(ast.unparse(tree).encode())
    return h.hexdigest()


def _git_head(root: str) -> str:
    """HEAD, with '-dirty' when the tree has uncommitted changes, or
    'unknown' outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--abbrev=40"], cwd=root,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "unknown"


def load(gallery_dir: str) -> dict:
    path = os.path.join(gallery_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def record(gallery_dir: str, artifact: str, info: dict) -> None:
    """Record `artifact` (filename within gallery_dir) with render
    metadata + the current sources digest."""
    root = repo_root()
    m = load(gallery_dir)
    m[artifact] = {
        **info,
        "render_sources_digest": render_sources_digest(root),
        # ast.unparse formatting can drift across Python MINOR versions,
        # which would falsely flag artifacts stale when the render and
        # CI interpreters differ — record the version so the staleness
        # test can distinguish real code drift from interpreter drift
        # (tests/test_golden_fullres.py skips digest comparison on
        # minor-version mismatch).
        "python_version": "%d.%d" % sys.version_info[:2],
        "git_commit": _git_head(root),
    }
    with open(os.path.join(gallery_dir, MANIFEST_NAME), "w") as f:
        json.dump(m, f, indent=2, sort_keys=True)
        f.write("\n")
