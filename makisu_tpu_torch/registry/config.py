"""Per-registry configuration map.

Copy of ``makisu_tpu/registry/config.py``. Reference:
lib/registry/config.go (ConfigurationMap[registry][repoRegex] :33-46,
Config fields :49-63, defaults :65-93, YAML/JSON load with $VAR
expansion :113-138) and lib/registry/security (basic auth, TLS, cred
helpers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

DEFAULT_CONCURRENCY = 3
DEFAULT_TIMEOUT = 180.0
DEFAULT_RETRIES = 3
DEFAULT_PUSH_RATE = 100 * 1024 * 1024     # bytes/sec token bucket
DEFAULT_PUSH_CHUNK = 50 * 1024 * 1024     # Content-Range chunk; -1 = whole


@dataclasses.dataclass
class SecurityConfig:
    tls_verify: bool = True
    ca_cert: str = ""
    # Mutual-TLS client identity (reference: httputil SendTLS options,
    # lib/registry/security/security.go:79 — enterprise registries that
    # authenticate clients by certificate).
    client_cert: str = ""
    client_key: str = ""
    basic_user: str = ""
    basic_password: str = ""
    cred_helper: str = ""  # docker-credential-<name> executable suffix
    # Cross-origin blob redirects normally use a default public-CA
    # transport (presigned S3/GCS URLs must not see the registry's
    # private CA or mTLS identity). Air-gapped setups whose redirect
    # target shares the registry's private CA set this to reuse the
    # registry transport for redirects.
    trust_redirects: bool = False

    @staticmethod
    def from_json(d: dict) -> "SecurityConfig":
        tls = d.get("tls") or {}
        basic = d.get("basic") or {}
        client = tls.get("client") or {}
        return SecurityConfig(
            tls_verify=not client.get("disabled", False),
            ca_cert=tls.get("ca", {}).get("cert", {}).get("path", ""),
            client_cert=client.get("cert", {}).get("path", ""),
            client_key=client.get("key", {}).get("path", ""),
            basic_user=basic.get("username", ""),
            basic_password=basic.get("password", ""),
            cred_helper=d.get("credsStore", ""),
            trust_redirects=bool(d.get("trust_redirects", False)),
        )


@dataclasses.dataclass
class RegistryConfig:
    concurrency: int = DEFAULT_CONCURRENCY
    timeout: float = DEFAULT_TIMEOUT
    retries: int = DEFAULT_RETRIES
    push_rate: float = DEFAULT_PUSH_RATE
    push_chunk: int = DEFAULT_PUSH_CHUNK
    security: SecurityConfig = dataclasses.field(default_factory=SecurityConfig)

    @staticmethod
    def from_json(d: dict) -> "RegistryConfig":
        return RegistryConfig(
            concurrency=d.get("concurrency", DEFAULT_CONCURRENCY),
            timeout=_seconds(d.get("timeout", DEFAULT_TIMEOUT)),
            retries=d.get("retries", DEFAULT_RETRIES),
            push_rate=d.get("push_rate", DEFAULT_PUSH_RATE),
            push_chunk=d.get("push_chunk", DEFAULT_PUSH_CHUNK),
            security=SecurityConfig.from_json(d.get("security") or {}),
        )


def _seconds(val) -> float:
    if isinstance(val, (int, float)):
        return float(val)
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h)?", str(val))
    if not m:
        raise ValueError(f"bad timeout: {val!r}")
    mult = {"ms": 0.001, "s": 1, "m": 60, "h": 3600, None: 1}[m.group(2)]
    return float(m.group(1)) * mult


# registry → repo-regex → config
ConfigurationMap = dict[str, dict[str, RegistryConfig]]

_global_config: ConfigurationMap = {
    "index.docker.io": {
        ".*": RegistryConfig(
            security=SecurityConfig(tls_verify=True)),
    },
}


def load_config_map(source: str) -> ConfigurationMap:
    """Parse a registry config map from a YAML/JSON file path or an
    inline JSON string, expanding ``$VARS`` from the environment. Each
    command carries its own map; the module's map holds the defaults."""
    if os.path.isfile(source):
        with open(source) as f:
            text = f.read()
    else:
        text = source
    text = os.path.expandvars(text)
    try:
        raw = json.loads(text)
    except ValueError:
        import yaml  # optional; ships with most ML images
        raw = yaml.safe_load(text)
    out: ConfigurationMap = {}
    for registry, repos in (raw or {}).items():
        out[registry] = {
            repo_regex: RegistryConfig.from_json(cfg or {})
            for repo_regex, cfg in repos.items()
        }
    return out


def config_for(registry: str, repository: str,
               config_map: ConfigurationMap | None = None) -> RegistryConfig:
    for source in (config_map, _global_config):
        repos = (source or {}).get(registry)
        if repos:
            for pattern, cfg in repos.items():
                if re.fullmatch(pattern, repository):
                    return cfg
    return RegistryConfig()
