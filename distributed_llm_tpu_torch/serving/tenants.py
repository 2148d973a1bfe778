"""Per-tenant quota enforcement.

Counterpart of ``distributed_llm_tpu/serving/tenants.py``.  One
``TenantQuotas`` registry per quota-on tier (``TierConfig.tenant_quotas``
is not None), consulted by ``TierClient`` before the tier's
``AdmissionController``: where the controller bounds the TIER (slots,
queue, predicted wait, pool pressure), this registry bounds each TENANT's
share of it: requests in flight and waiting, a device-time-rate token
bucket debited from the measured ``device_time_ms`` bill, and the
resident-KV block budget the engine bills at 1/refcount.

Billing is post-paid: a request admits against the bucket's current level
and its measured device time is debited at the router's exactly-once
``_finish_request`` exit, so a tenant that burned more than its rate
allows goes negative and is refused until the refill catches up.

A refusal returns a reason string that the tier client wraps in the
reference error shape with ``retry_after_s`` (the bucket's time to
positive, or 1 s), so the Router's failover and perf penalty fire as for
a tier-level refusal.  Every mutable field is guarded by ``_lock``:
admissions run on serving threads, releases and debits on tier worker
threads.

The JAX package reads the default quota's limits from ``DLLM_TENANT_*``
environment variables; the port takes them as arguments of
``default_quota``, and with none the default quota is unlimited, as
JAX's with the variables unset.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..config import TenantQuota, TierConfig

# The tenant a request without a tenant_id bills to (serving/app.py):
# tenant-less clients share one identity, so a quotas-on deployment can
# bound them together while tenant-aware clients are billed one by one.
DEFAULT_TENANT = "default"


def default_quota(max_inflight: Optional[int] = None,
                  max_queued: Optional[int] = None,
                  device_ms_per_s: Optional[float] = None,
                  kv_blocks: Optional[int] = None,
                  spec_gamma_max: Optional[int] = None) -> TenantQuota:
    """The quota of tenants absent from ``TierConfig.tenant_quotas``
    (JAX's ``DLLM_TENANT_MAX_INFLIGHT``, ``_MAX_QUEUED``,
    ``_DEVICE_MS_PER_S``, ``_KV_BLOCKS`` and ``_GAMMA_MAX``, as
    arguments).  None or zero turns that criterion off."""
    return TenantQuota(
        max_inflight=max_inflight or None,
        max_queued=max_queued or None,
        device_ms_per_s=device_ms_per_s or None,
        kv_blocks=kv_blocks or None,
        spec_gamma_max=spec_gamma_max or None,
    )


class TenantQuotas:
    """Per-tenant admission budgets for ONE tier.

    ``try_admit`` / ``release`` bracket each request like the
    ``AdmissionController`` pair (the caller owns the exactly-once
    release); ``debit`` feeds the token bucket from the measured bill.
    ``now`` is the bucket's clock (injectable for tests).  A quotas-off
    tier never builds one."""

    def __init__(self, tier: TierConfig, now=time.monotonic):
        self.tier = tier
        self._now = now
        self._quotas: Dict[str, TenantQuota] = dict(tier.tenant_quotas
                                                    or {})
        self._default = default_quota()
        self._lock = threading.Lock()
        # tenant -> requests admitted against the quota, not released.
        self._active: Dict[str, int] = {}
        # tenant -> [level_ms, last_refill_t]; levels go negative on the
        # post-paid debit and refill at quota.device_ms_per_s.
        self._buckets: Dict[str, list] = {}
        self.admitted = 0
        self.rejected = 0

    def quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self._default)

    def weight(self, tenant: str) -> float:
        return max(1e-6, float(self.quota(tenant).weight))

    def gamma_cap(self, tenant: str) -> Optional[int]:
        return self.quota(tenant).spec_gamma_max

    def kv_budget(self, tenant: str) -> Optional[int]:
        return self.quota(tenant).kv_blocks

    def _burst_ms(self, q: TenantQuota) -> float:
        if q.device_ms_burst is not None:
            return float(q.device_ms_burst)
        return 2.0 * float(q.device_ms_per_s or 0.0)

    def _bucket_level(self, tenant: str, q: TenantQuota) -> Optional[float]:
        """Refill, then read the tenant's bucket (callers hold ``_lock``);
        None when the tenant has no rate budget."""
        if not q.device_ms_per_s:
            return None
        t = self._now()
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = [self._burst_ms(q), t]
            self._buckets[tenant] = bucket
        level, last = bucket
        level = min(self._burst_ms(q),
                    level + (t - last) * float(q.device_ms_per_s))
        bucket[0] = level
        bucket[1] = t
        return level

    def try_admit(self, tenant: str,
                  kv_bill: Optional[float] = None) -> Optional[str]:
        """None = admitted (the caller MUST ``release(tenant)`` exactly
        once); else the refusal's reason.  ``kv_bill`` is the tenant's
        resident-KV bill in 1/refcount blocks (the tier engine's
        ``tenant_kv_blocks``): over its budget, the tenant's cold
        admissions are refused until the bill drops."""
        q = self.quota(tenant)
        with self._lock:
            active = self._active.get(tenant, 0)
            if q.max_inflight is not None:
                cap = q.max_inflight + (q.max_queued or 0)
                if active >= cap:
                    self.rejected += 1
                    return (f"tenant '{tenant}' queue full ({active} in "
                            f"flight/waiting, cap {cap})")
            level = self._bucket_level(tenant, q)
            if level is not None and level <= 0.0:
                self.rejected += 1
                return (f"tenant '{tenant}' device-time budget exhausted "
                        f"(bucket {level:.0f} ms at "
                        f"{q.device_ms_per_s:g} ms/s)")
            if (kv_bill is not None and q.kv_blocks is not None
                    and kv_bill > q.kv_blocks):
                self.rejected += 1
                return (f"tenant '{tenant}' projected KV demand over "
                        f"budget (resident bill {kv_bill:.1f} blocks, "
                        f"budget {q.kv_blocks})")
            self._active[tenant] = active + 1
            self.admitted += 1
        self._set_inflight(tenant)
        return None

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._active.get(tenant, 0)
            if n <= 1:
                self._active.pop(tenant, None)
            else:
                self._active[tenant] = n - 1
        self._set_inflight(tenant)

    def debit(self, tenant: str, device_ms: float) -> None:
        """Charge the measured device-time bill to the tenant's bucket
        (the router's ``_finish_request``, once per request).  A no-op
        for a tenant without a rate budget."""
        if not device_ms:
            return
        q = self.quota(tenant)
        with self._lock:
            level = self._bucket_level(tenant, q)
            if level is None:
                return
            self._buckets[tenant][0] = level - float(device_ms)

    def retry_after_s(self, tenant: str) -> float:
        """The retry hint of a tenant refusal: the bucket's time to
        positive when the rate budget binds, else 1 s (a queue or KV
        refusal clears when a request finishes)."""
        q = self.quota(tenant)
        with self._lock:
            level = self._bucket_level(tenant, q)
        if level is not None and level < 0.0 and q.device_ms_per_s:
            return max(0.1, round(-level / float(q.device_ms_per_s), 2))
        return 1.0

    def _set_inflight(self, tenant: str) -> None:
        # The process-global registry (the engine counters' pattern), the
        # tenant label bounded through the registry's BoundedLabels set.
        from ..obs import get_observability
        obs = get_observability()
        with self._lock:
            n = self._active.get(tenant, 0)
        obs.m.tenant_inflight_g.labels(
            self.tier.name, obs.tenant_labels.label(tenant)).set(n)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            buckets = {t: round(b[0], 2) for t, b in self._buckets.items()}
            return {
                "tenants": sorted(set(self._quotas) | set(self._active)),
                "active": dict(self._active),
                "bucket_ms": buckets,
                "admitted": self.admitted,
                "rejected": self.rejected,
            }
