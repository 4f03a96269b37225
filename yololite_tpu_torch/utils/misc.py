"""Auxiliary utilities: settings persistence, retry/guard decorators, thread locks, environment probes,
seeding (port of yololite_tpu/utils/misc.py).

Nothing here runs at import: the settings file is read and written only when
`get_settings()` is first called, and no probe touches the network unless
called (`is_online`).
"""

from __future__ import annotations

import functools
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

from yololite_tpu_torch.utils import LOGGER


def clean_str(s):
    """Replace special characters in a string with underscores."""
    import re

    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)


class SimpleClass:
    """Base giving subclasses a readable attribute-dump str/repr and a helpful
    missing-attribute error. Results and Boxes inherit it."""

    def __str__(self):
        attrs = []
        for a in dir(self):
            v = getattr(self, a)
            if not callable(v) and not a.startswith("_"):
                if isinstance(v, SimpleClass):
                    s = f"{a}: {v.__module__}.{v.__class__.__name__} object"
                else:
                    s = f"{a}: {v!r}"
                attrs.append(s)
        return f"{self.__module__}.{self.__class__.__name__} object with attributes:\n\n" + "\n".join(attrs)

    def __repr__(self):
        return self.__str__()

    def __getattr__(self, attr):
        name = self.__class__.__name__
        raise AttributeError(f"'{name}' object has no attribute '{attr}'. See valid attributes below.\n{self.__doc__}")


class TryExcept:
    """Context manager / decorator that logs exceptions instead of raising."""

    def __init__(self, msg: str = "", verbose: bool = True):
        self.msg = msg
        self.verbose = verbose

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with self:
                return func(*args, **kwargs)

        return wrapper

    def __enter__(self):
        return self

    def __exit__(self, exc_type, value, tb):
        if self.verbose and value:
            LOGGER.warning(f"{self.msg}{': ' if self.msg else ''}{value}")
        return True


def retry(times: int = 3, delay: float = 2.0):
    """Decorator retrying a function with exponential backoff."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            attempt = 0
            while attempt < times:
                try:
                    return func(*args, **kwargs)
                except Exception as e:
                    attempt += 1
                    if attempt >= times:
                        raise
                    LOGGER.warning(f"Retry {attempt}/{times} for {func.__name__} after error: {e}")
                    time.sleep(delay * (2 ** (attempt - 1)))

        return wrapper

    return decorator


class ThreadingLocked:
    """Decorator serializing calls to a function across threads."""

    def __init__(self):
        self.lock = threading.Lock()

    def __call__(self, f):
        @functools.wraps(f)
        def decorated(*args, **kwargs):
            with self.lock:
                return f(*args, **kwargs)

        return decorated


class JSONDict(dict):
    """Thread-safe dict persisted to a JSON file on every mutation."""

    def __init__(self, file_path="data.json"):
        super().__init__()
        self.file_path = Path(file_path)
        self.lock = threading.Lock()
        self._load()

    def _load(self):
        try:
            if self.file_path.exists():
                with open(self.file_path) as f:
                    self.update(json.load(f))
        except Exception as e:
            LOGGER.warning(f"Error reading {self.file_path}: {e}")

    def _save(self):
        try:
            self.file_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.file_path, "w", encoding="utf-8") as f:
                json.dump(dict(self), f, indent=2, default=str)
        except Exception as e:
            LOGGER.warning(f"Error writing {self.file_path}: {e}")

    def __setitem__(self, key, value):
        with self.lock:
            super().__setitem__(key, value)
            self._save()

    def __delitem__(self, key):
        with self.lock:
            super().__delitem__(key)
            self._save()

    def update(self, *args, **kwargs):
        with self.lock:
            super().update(*args, **kwargs)
        self._save()

    def clear(self):
        with self.lock:
            super().clear()
            self._save()


class SettingsManager(JSONDict):
    """Persistent framework settings (datasets/weights/runs dirs)."""

    def __init__(self, file=None, version="1.0.0"):
        root = Path.home() / ".config" / "yololite_tpu_torch"
        file = Path(file) if file else root / "settings.json"
        self.defaults = {
            "settings_version": version,
            "datasets_dir": str(root.parent.parent / "datasets"),
            "weights_dir": str(root / "weights"),
            "runs_dir": str(root / "runs"),
            "sync": True,
        }
        super().__init__(file)
        if not self or self.get("settings_version") != version:
            merged = {**self.defaults, **self}
            merged["settings_version"] = version
            self.update(merged)

    def reset(self):
        self.clear()
        self.update(self.defaults)


SETTINGS: Optional[SettingsManager] = None


def get_settings() -> SettingsManager:
    """Lazily construct the global settings manager (no import-time side effects)."""
    global SETTINGS
    if SETTINGS is None:
        SETTINGS = SettingsManager()
    return SETTINGS


# ---- environment detection + small host helpers ----

def emojis(string: str = "") -> str:
    """Emoji-safe string for non-UTF consoles."""
    import platform

    return string.encode().decode("ascii", "ignore") if platform.system() == "Windows" else string


def clean_url(url) -> str:
    """Strip auth/query from a URL."""
    import urllib.parse

    url = Path(url).as_posix().replace(":/", "://")  # Pathlib collapses ://
    return urllib.parse.unquote(url).split("?")[0]


def url2file(url) -> str:
    """URL -> bare filename."""
    return Path(clean_url(url)).name


def is_dir_writeable(dir_path) -> bool:
    """True when the process may write into dir_path."""
    import os

    return os.access(str(dir_path), os.W_OK)


def is_ubuntu() -> bool:
    """True on Ubuntu."""
    try:
        with open("/etc/os-release") as f:
            return "ID=ubuntu" in f.read()
    except FileNotFoundError:
        return False


def get_ubuntu_version():
    """Ubuntu VERSION_ID or None."""
    import re

    if is_ubuntu():
        try:
            with open("/etc/os-release") as f:
                return re.search(r'VERSION_ID="(\d+\.\d+)"', f.read())[1]
        except (FileNotFoundError, AttributeError, TypeError):
            return None


def is_colab() -> bool:
    """True inside Google Colab."""
    import os

    return "COLAB_RELEASE_TAG" in os.environ or "COLAB_BACKEND_VERSION" in os.environ


def is_kaggle() -> bool:
    """True inside a Kaggle kernel."""
    import os

    return os.environ.get("PWD") == "/kaggle/working" and \
        os.environ.get("KAGGLE_URL_BASE") == "https://www.kaggle.com"


def is_jupyter() -> bool:
    """True in the notebook environments we can reliably detect."""
    return is_colab() or is_kaggle()


def is_docker() -> bool:
    """True inside a Docker container."""
    try:
        with open("/proc/self/cgroup") as f:
            return "docker" in f.read()
    except Exception:
        return False


def read_device_model() -> str:
    """Contents of /proc/device-tree/model, or ''."""
    try:
        with open("/proc/device-tree/model") as f:
            return f.read()
    except Exception:
        return ""


def is_raspberrypi() -> bool:
    """True on a Raspberry Pi."""
    return "Raspberry Pi" in read_device_model()


def is_jetson() -> bool:
    """True on an NVIDIA Jetson."""
    return "NVIDIA" in read_device_model()


def is_online() -> bool:
    """True when a known DNS host is reachable."""
    import os
    import socket

    if str(os.getenv("YOLO_OFFLINE", "")).lower() == "true":
        return False
    for dns in ("1.1.1.1", "8.8.8.8"):
        try:
            socket.create_connection(address=(dns, 80), timeout=2.0).close()
            return True
        except Exception:
            continue
    return False


def is_pytest_running() -> bool:
    """True when pytest is driving the process."""
    import os
    import sys

    return ("PYTEST_CURRENT_TEST" in os.environ) or ("pytest" in sys.modules) or \
        ("pytest" in Path(sys.argv[0]).stem)


def is_github_action_running() -> bool:
    """True on a GitHub Actions runner."""
    import os

    return all(k in os.environ for k in ("GITHUB_ACTIONS", "GITHUB_WORKFLOW", "RUNNER_OS"))


def is_pip_package(filepath: str = __name__) -> bool:
    """True when `filepath` resolves to an importable module with a real origin
   ."""
    import importlib.util

    spec = importlib.util.find_spec(filepath)
    return spec is not None and spec.origin is not None


def get_git_dir() -> Optional[Path]:
    """Repo root containing this package, or None."""
    for d in Path(__file__).parents:
        if (d / ".git").is_dir():
            return d
    return None


def is_git_dir() -> bool:
    """True when this package lives inside a git checkout."""
    return get_git_dir() is not None


def get_git_origin_url() -> Optional[str]:
    """origin URL of the enclosing git repo, or None."""
    import subprocess

    if is_git_dir():
        try:
            out = subprocess.check_output(["git", "config", "--get", "remote.origin.url"],
                                          cwd=get_git_dir(), stderr=subprocess.DEVNULL)
            return out.decode().strip()
        except Exception:
            return None
    return None


def get_git_branch() -> Optional[str]:
    """Current branch of the enclosing git repo, or None."""
    import subprocess

    if is_git_dir():
        try:
            out = subprocess.check_output(["git", "rev-parse", "--abbrev-ref", "HEAD"],
                                          cwd=get_git_dir(), stderr=subprocess.DEVNULL)
            return out.decode().strip()
        except Exception:
            return None
    return None


@functools.lru_cache(maxsize=1)
def get_cpu_info() -> str:
    """Host CPU description, e.g. 'Intel Xeon ...'.

    Reads /proc/cpuinfo, falling back to platform.processor(); cached.
    """
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    s = line.split(":", 1)[1].strip()
                    return s.replace("(R)", "").replace("CPU ", "").replace("@ ", "")
    except OSError:
        pass
    return platform.processor() or "unknown"


def get_user_config_dir(sub_dir: str = "yololite_tpu_torch") -> Path:
    """Per-OS user config directory."""
    import platform

    home = Path.home()
    path = {
        "Windows": home / "AppData" / "Roaming" / sub_dir,
        "Darwin": home / "Library" / "Application Support" / sub_dir,
    }.get(platform.system(), home / ".config" / sub_dir)
    return path


def threaded(func):
    """Run the wrapped call in a daemon thread unless threaded=False."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if kwargs.pop("threaded", True):
            t = threading.Thread(target=func, args=args, kwargs=kwargs, daemon=True)
            t.start()
            return t
        return func(*args, **kwargs)

    return wrapper


def plt_settings(rcparams: Optional[Dict] = None, backend: str = "Agg"):
    """Decorator: run a plotting function under temporary rcParams + backend
   ."""
    if rcparams is None:
        rcparams = {"font.size": 11}

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            import matplotlib.pyplot as plt

            original = plt.get_backend()
            switch = backend.lower() != original.lower()
            if switch:
                plt.close("all")
                plt.switch_backend(backend)
            try:
                with plt.rc_context(rcparams):
                    return func(*args, **kwargs)
            finally:
                if switch:
                    plt.close("all")
                    plt.switch_backend(original)

        return wrapper

    return decorator


def deprecation_warn(arg, new_arg):
    """Warn that `arg` is deprecated in favor of `new_arg`."""
    LOGGER.warning(f"'{arg}' is deprecated and will be removed in the future. Use '{new_arg}' instead.")


def remove_colorstr(input_string: str) -> str:
    """Strip ANSI escape codes."""
    import re

    return re.compile(r"\x1B\[[0-9;]*[A-Za-z]").sub("", input_string)


def copy_attr(a, b, include=(), exclude=()):
    """Copy public attributes of b onto a."""
    for k, v in b.__dict__.items():
        if (include and k not in include) or k.startswith("_") or k in exclude:
            continue
        setattr(a, k, v)


def get_default_args(func) -> Dict[str, Any]:
    """{param: default} for every defaulted parameter."""
    import inspect

    return {k: v.default for k, v in inspect.signature(func).parameters.items()
            if v.default is not inspect.Parameter.empty}


def init_seeds(seed: int = 0, deterministic: bool = False):
    """Seed python's random, numpy and torch (every card too); with deterministic, also make torch pick
    deterministic kernels (cuDNN without autotuning, cuBLAS with a fixed workspace) and fix the hash seed."""
    import os
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.cuda.manual_seed_all(seed)
    if deterministic:
        os.environ["PYTHONHASHSEED"] = str(seed)
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def time_sync() -> float:
    """Wall time after the card has finished its queued work (the host clock alone without a card)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.time()


def smart_inference_mode():
    """Decorator: run the function under torch.inference_mode()."""
    import torch

    def decorate(fn):
        return torch.inference_mode()(fn)

    return decorate


def default_class_names(data=None) -> Dict[int, str]:
    """Class names from a dataset yaml, or numeric defaults."""
    if data:
        try:
            from yololite_tpu_torch.utils import yaml_load

            return yaml_load(data)["names"]
        except Exception:
            pass
    return {i: f"class{i}" for i in range(999)}
