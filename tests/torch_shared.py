"""Work that the PyTorch port's test fixtures share across the xdist
workers of one pytest session.

Under ``--dist load`` the tests of one module are spread over the workers,
and every worker that runs one of them builds the module's fixtures again.
``shared(root, name, make)`` runs ``make(directory)`` once for the
session: the workers share ``root`` (``session_root``: the base temp
directory's parent under xdist, which pytest makes for the session), the
first worker to ask makes the entry under a file lock, and the others wait
for it and read back what ``make`` returned (pickled). Without xdist it is
the session's own base temp directory."""

import os
import pickle

from filelock import FileLock


def session_root(tmp_path_factory) -> str:
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)


def shared(root: str, name: str, make):
    """``make(directory)``'s value, made once for the session in
    ``<root>/shared_<name>/``."""
    directory = os.path.join(root, "shared_" + name)
    with FileLock(directory + ".lock"):
        done = os.path.join(directory, "made.pkl")
        if os.path.exists(done):
            with open(done, "rb") as f:
                return pickle.load(f)
        os.makedirs(directory, exist_ok=True)
        value = make(directory)
        with open(done, "wb") as f:
            pickle.dump(value, f)
        return value
