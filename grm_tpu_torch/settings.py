"""Persistent CLI settings store (port of ``grm_tpu/settings.py``): the
headless equivalent of the GUI's ``data/settings.json`` (reference
``src/app.py:62-64, 213-223``).

The reference persists {"general": {"amr_database": <path>, "amr_date":
<timestamp>}} and reloads it at startup; missing/corrupt files fall back
to defaults silently (``load_settings``). Same contract here, with the
file at ``$GRM_SETTINGS_PATH`` or ``~/.grm/settings.json``. The collect
commands read ``amr_database`` as the default metadata location and
record ``amr_date`` after update checks.
"""

from __future__ import annotations

import json
import os

__all__ = ["settings_path", "load_settings", "save_settings",
           "get_setting", "set_setting", "DEFAULT_SETTINGS"]

DEFAULT_SETTINGS = {
    "general": {"amr_database": "", "amr_date": "0000-00-00 00:00:00"}
}


def settings_path():
    return os.environ.get(
        "GRM_SETTINGS_PATH",
        os.path.join(os.path.expanduser("~"), ".grm", "settings.json"))


def load_settings():
    """Stored settings merged over the defaults; silent fallback on a
    missing or corrupt file (the reference's load_settings contract)."""
    merged = {k: dict(v) for k, v in DEFAULT_SETTINGS.items()}
    try:
        with open(settings_path()) as f:
            stored = json.load(f)
        for section, values in stored.items():
            if isinstance(values, dict):
                merged.setdefault(section, {}).update(values)
            else:
                merged[section] = values
    except Exception:
        pass
    return merged


def save_settings(settings):
    path = settings_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(settings, f, indent=2)


def get_setting(key, section="general"):
    return load_settings().get(section, {}).get(key)


def set_setting(key, value, section="general"):
    settings = load_settings()
    settings.setdefault(section, {})[key] = value
    save_settings(settings)
    return settings
