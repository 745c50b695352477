"""``--user-dir``: import a directory of out-of-tree components once, so
that what it registers (``registry.TASKS.register``, ``CRITERIONS``,
``TOKENIZERS``, ``BPES``, ``registry.register_architecture``) is there
before the parse.

The port's copy of ``fbk_fairseq_st_tpu/utils/user_dir.py`` (reference
fairseq/utils.py:344-358), with its rules: the path is taken by its
realpath, so a directory reached again by another spelling is not
imported twice; a directory whose name an imported module already holds
is imported under a private alias (``fbk_user_dir_<hash>``) from its
``__init__.py``, and a failed import leaves no half-imported module
behind."""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import sys


def import_user_module(args) -> None:
    module_path = getattr(args, "user_dir", None)
    if module_path is None:
        return
    # realpath, not abspath: the same directory reached via a symlink or a
    # different spelling must count as already-imported, or __init__.py
    # would re-execute and blow up on duplicate registration
    module_path = os.path.realpath(module_path)
    if not os.path.exists(module_path):
        raise FileNotFoundError(module_path)
    module_parent, module_name = os.path.split(module_path)

    existing = sys.modules.get(module_name)
    if existing is not None:
        # already imported — but only count it if it IS this directory.
        # The reference skips on any name hit, silently ignoring a user
        # dir that shadows an installed package (e.g. a dir named
        # 'examples'); here the collision imports under a private alias
        # instead, so registration always happens exactly once.
        existing_path = getattr(existing, "__user_dir_path__", None) or (
            os.path.dirname(
                os.path.realpath(getattr(existing, "__file__", ""))
            )
            if getattr(existing, "__file__", None)
            else None
        )
        if existing_path == module_path:
            return
        alias = "fbk_user_dir_" + hashlib.sha1(
            module_path.encode()
        ).hexdigest()[:12]
        if alias in sys.modules:
            return
        init_py = os.path.join(module_path, "__init__.py")
        if not os.path.exists(init_py):
            raise ImportError(
                f"--user-dir {module_path} collides with an imported "
                f"module named {module_name!r} and has no __init__.py to "
                f"import it under an alias"
            )
        spec = importlib.util.spec_from_file_location(
            alias, init_py, submodule_search_locations=[module_path]
        )
        module = importlib.util.module_from_spec(spec)
        module.__user_dir_path__ = module_path
        sys.modules[alias] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            # like the import machinery: a failed import must not stay
            # cached, or every retry would silently no-op with nothing
            # registered
            sys.modules.pop(alias, None)
            raise
        return

    sys.path.insert(0, module_parent)
    module = importlib.import_module(module_name)
    module.__user_dir_path__ = module_path
