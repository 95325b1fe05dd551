"""The port's bucket-configuration modules against the JAX package's.

``utils/tags.py``, ``ilm/lifecycle.py``, ``objectlayer/objectlock.py``
and ``objectlayer/quota.py`` are host code; each is fed the same inputs
as its ``minio_tpu`` counterpart, and must give the same answer:

* documents parsed and serialized again are byte-equal (tag sets and
  the ``x-amz-tagging`` header form, lifecycle rules, object-lock
  configurations, retentions, legal holds, quota JSON), and a rejected
  document is rejected with the same error class and message;
  hypothesis draws tag sets and lifecycle rules from their grammars;
* ``Lifecycle.compute_action`` over a grid of ``ObjectOpts`` and
  ``now_ns`` drawn from a numpy seed, and ``abort_multipart_before_ns``;
* the lock metadata from PUT headers, the governance bypass header and
  ``retention_blocks_delete`` over a matrix of versions;
* ``quota.config_for``, ``bucket_size`` (the crawler's snapshot, else a
  walk of the listing) and ``enforce_put``.
"""

from __future__ import annotations

import dataclasses
import datetime
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from minio_tpu.ilm import lifecycle as jlc
from minio_tpu.objectlayer import objectlock as jlock
from minio_tpu.objectlayer import quota as jquota
from minio_tpu.server.s3errors import S3Error as JS3Error
from minio_tpu.utils import tags as jtags
from minio_tpu_torch.ilm import lifecycle as tlc
from minio_tpu_torch.objectlayer import objectlock as tlock
from minio_tpu_torch.objectlayer import quota as tquota
from minio_tpu_torch.server.s3errors import S3Error as TS3Error
from minio_tpu_torch.utils import tags as ttags
from tests.test_torch_threads import torch_threads  # noqa: F401

NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
DAY_NS = 86400 * 10**9
# a fixed "now" for everything that reads the clock
NOW = datetime.datetime(2026, 3, 1, 12, 0, 0, tzinfo=datetime.timezone.utc)
NOW_NS = int(NOW.timestamp()) * 10**9


def _outcome(fn, *args, **kw):
    """('ok', value) or ('err', class name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the error is the answer
        return ("err", type(e).__name__, str(e))


@pytest.fixture
def fixed_clock(monkeypatch):
    for mod in (tlock, jlock):
        monkeypatch.setattr(mod, "utcnow", lambda: NOW)


# -- tags ------------------------------------------------------------------

TAG_DOCS = {
    "one": f"<Tagging {NS}><TagSet><Tag><Key>a</Key><Value>1</Value></Tag>"
           "</TagSet></Tagging>",
    "two": "<Tagging><TagSet><Tag><Key>k1</Key><Value>v 1</Value></Tag>"
           "<Tag><Key>k2</Key><Value></Value></Tag></TagSet></Tagging>",
    "escaped": "<Tagging><TagSet><Tag><Key>a&amp;b</Key>"
               "<Value>&lt;x&gt;</Value></Tag></TagSet></Tagging>",
    "no_value": "<Tagging><TagSet><Tag><Key>k</Key></Tag></TagSet></Tagging>",
    "empty_set": "<Tagging><TagSet/></Tagging>",
    "key_spaces": "<Tagging><TagSet><Tag><Key>  k  </Key><Value>v</Value>"
                  "</Tag></TagSet></Tagging>",
    "dup_key": "<Tagging><TagSet><Tag><Key>k</Key><Value>1</Value></Tag>"
               "<Tag><Key>k</Key><Value>2</Value></Tag></TagSet></Tagging>",
    "missing_key": "<Tagging><TagSet><Tag><Value>1</Value></Tag></TagSet>"
                   "</Tagging>",
    "empty_key": "<Tagging><TagSet><Tag><Key></Key><Value>1</Value></Tag>"
                 "</TagSet></Tagging>",
    "long_key": "<Tagging><TagSet><Tag><Key>" + "k" * 129 + "</Key>"
                "<Value>1</Value></Tag></TagSet></Tagging>",
    "long_value": "<Tagging><TagSet><Tag><Key>k</Key><Value>" + "v" * 257
                  + "</Value></Tag></TagSet></Tagging>",
    "eleven": "<Tagging><TagSet>" + "".join(
        f"<Tag><Key>k{i}</Key><Value>v</Value></Tag>" for i in range(11))
        + "</TagSet></Tagging>",
    "wrong_root": "<Tags><TagSet/></Tags>",
    "malformed": "<Tagging><TagSet>",
}


@pytest.mark.parametrize("limit", [jtags.MAX_OBJECT_TAGS,
                                   jtags.MAX_BUCKET_TAGS])
@pytest.mark.parametrize("name", sorted(TAG_DOCS))
def test_tag_xml_round_trip(name, limit):
    body = TAG_DOCS[name].encode()
    got = _outcome(ttags.from_xml, body, limit)
    want = _outcome(jtags.from_xml, body, limit)
    assert got == want
    if got[0] == "ok":
        assert ttags.to_xml(got[1]) == jtags.to_xml(want[1])


HEADERS = ["", "a=b", "a=b&c=d", "a=&b", "k%20x=v%2Fy", "a=1&a=2",
           "=v", "&".join(f"k{i}=v" for i in range(11)),
           "k=" + "v" * 257, "a=b=c", "x=%E2%9C%93"]


@pytest.mark.parametrize("value", HEADERS)
def test_tag_header_round_trip(value):
    got = _outcome(ttags.from_header, value)
    want = _outcome(jtags.from_header, value)
    assert got == want
    if got[0] == "ok":
        enc = ttags.encode(got[1])
        assert enc == jtags.encode(want[1])
        assert ttags.decode(enc) == jtags.decode(enc)


_TAG_TEXT = st.text(
    st.characters(min_codepoint=32, max_codepoint=0x2FFF,
                  blacklist_categories=("Cs",)),
    max_size=12,
)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(_TAG_TEXT.filter(lambda k: k.strip() == k and k),
                       _TAG_TEXT, max_size=12))
def test_tag_grammar_hypothesis(tags):
    """Any tag set: the same XML, the same parse of it, the same header
    form and the same parse of that."""
    xml = ttags.to_xml(tags)
    assert xml == jtags.to_xml(tags)
    assert _outcome(ttags.from_xml, xml, 10) == \
        _outcome(jtags.from_xml, xml, 10)
    enc = ttags.encode(tags)
    assert enc == jtags.encode(tags)
    assert _outcome(ttags.from_header, enc) == _outcome(jtags.from_header, enc)


# -- lifecycle -------------------------------------------------------------

def _rule(body: str) -> str:
    return f"<Rule>{body}</Rule>"


def _lc(*rules: str, root: str = "LifecycleConfiguration") -> str:
    return f"<{root} {NS}>{''.join(rules)}</{root}>"


EXP30 = "<Expiration><Days>30</Days></Expiration>"
LC_DOCS = {
    "days": _lc(_rule("<ID>r</ID><Status>Enabled</Status>"
                      "<Filter><Prefix>logs/</Prefix></Filter>" + EXP30)),
    "date": _lc(_rule("<Status>Enabled</Status><Filter/><Expiration>"
                      "<Date>2020-01-01T00:00:00Z</Date></Expiration>")),
    "date_naive": _lc(_rule("<Status>Enabled</Status><Expiration>"
                            "<Date>2021-06-01T00:00:00</Date></Expiration>")),
    "legacy_prefix": _lc(_rule("<Status>Enabled</Status><Prefix>tmp/</Prefix>"
                               + EXP30)),
    "tag": _lc(_rule("<Status>Enabled</Status><Filter><Tag><Key>t</Key>"
                     "<Value>1</Value></Tag></Filter>" + EXP30)),
    "and": _lc(_rule("<Status>Enabled</Status><Filter><And><Prefix>p/"
                     "</Prefix><Tag><Key>a</Key><Value>1</Value></Tag><Tag>"
                     "<Key>b</Key><Value>2</Value></Tag></And></Filter>"
                     + EXP30)),
    "and_tags_only": _lc(_rule("<Status>Enabled</Status><Filter><And><Tag>"
                               "<Key>a</Key><Value>1</Value></Tag><Tag><Key>b"
                               "</Key><Value>2</Value></Tag></And></Filter>"
                               + EXP30)),
    "noncurrent": _lc(_rule("<Status>Enabled</Status><Filter/>"
                            "<NoncurrentVersionExpiration><NoncurrentDays>7"
                            "</NoncurrentDays></NoncurrentVersionExpiration>"
                            )),
    "abort": _lc(_rule("<Status>Enabled</Status><Filter><Prefix>up/</Prefix>"
                       "</Filter><AbortIncompleteMultipartUpload>"
                       "<DaysAfterInitiation>3</DaysAfterInitiation>"
                       "</AbortIncompleteMultipartUpload>")),
    "marker": _lc(_rule("<Status>Enabled</Status><Expiration>"
                        "<ExpiredObjectDeleteMarker>true"
                        "</ExpiredObjectDeleteMarker></Expiration>")),
    "disabled": _lc(_rule("<Status>Disabled</Status>" + EXP30)),
    "two_rules": _lc(_rule("<ID>a</ID><Status>Enabled</Status>" + EXP30),
                     _rule("<ID>b</ID><Status>Enabled</Status>"
                           "<NoncurrentVersionExpiration><NoncurrentDays>1"
                           "</NoncurrentDays></NoncurrentVersionExpiration>")),
    "bucket_root": _lc(_rule("<Status>Enabled</Status>" + EXP30),
                       root="BucketLifecycleConfiguration"),
    "bad_status": _lc(_rule("<Status>On</Status>" + EXP30)),
    "transition": _lc(_rule("<Status>Enabled</Status><Transition><Days>1"
                            "</Days></Transition>" + EXP30)),
    "two_filters": _lc(_rule("<Status>Enabled</Status><Filter><Prefix>a"
                             "</Prefix><Tag><Key>k</Key><Value>v</Value>"
                             "</Tag></Filter>" + EXP30)),
    "dup_and_key": _lc(_rule("<Status>Enabled</Status><Filter><And><Tag>"
                             "<Key>a</Key><Value>1</Value></Tag><Tag><Key>a"
                             "</Key><Value>2</Value></Tag></And></Filter>"
                             + EXP30)),
    "tag_no_key": _lc(_rule("<Status>Enabled</Status><Filter><Tag><Value>1"
                            "</Value></Tag></Filter>" + EXP30)),
    "days_zero": _lc(_rule("<Status>Enabled</Status><Expiration><Days>0"
                           "</Days></Expiration>")),
    "days_text": _lc(_rule("<Status>Enabled</Status><Expiration><Days>x"
                           "</Days></Expiration>")),
    "bad_date": _lc(_rule("<Status>Enabled</Status><Expiration><Date>soon"
                          "</Date></Expiration>")),
    "days_and_date": _lc(_rule("<Status>Enabled</Status><Expiration><Days>1"
                               "</Days><Date>2020-01-01T00:00:00Z</Date>"
                               "</Expiration>")),
    "no_action": _lc(_rule("<ID>x</ID><Status>Enabled</Status>")),
    "no_rules": _lc(),
    "dup_ids": _lc(_rule("<ID>a</ID><Status>Enabled</Status>" + EXP30),
                   _rule("<ID>a</ID><Status>Enabled</Status>" + EXP30)),
    "wrong_root": "<Lifecycle/>",
    "malformed": "<LifecycleConfiguration><Rule>",
}


@pytest.mark.parametrize("name", sorted(LC_DOCS))
def test_lifecycle_round_trip(name):
    raw = LC_DOCS[name].encode()
    got = _outcome(tlc.Lifecycle.from_xml, raw)
    want = _outcome(jlc.Lifecycle.from_xml, raw)
    if got[0] == "ok":
        assert want[0] == "ok"
        assert [dataclasses.asdict(r) for r in got[1].rules] == \
            [dataclasses.asdict(r) for r in want[1].rules]
        out = got[1].to_xml()
        assert out == want[1].to_xml()
        # the serialized form parses back to itself in both packages
        assert tlc.Lifecycle.from_xml(out).to_xml() == out
        assert jlc.Lifecycle.from_xml(out).to_xml() == out
    else:
        assert got == want


_PREFIX = st.sampled_from(["", "a/", "logs/", "x", "up/", "ü/"])
_TAGS = st.lists(st.tuples(st.sampled_from(["a", "b", "c"]),
                           st.sampled_from(["", "1", "2"])),
                 max_size=3, unique_by=lambda t: t[0])
_DAYS = st.one_of(st.none(), st.integers(1, 400))


@st.composite
def _rules_xml(draw):
    rules = []
    for i in range(draw(st.integers(1, 4))):
        prefix, tags = draw(_PREFIX), draw(_TAGS)
        body = f"<ID>r{i}</ID><Status>{draw(st.sampled_from(['Enabled', 'Disabled']))}</Status>"
        tag_xml = "".join(f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>"
                          for k, v in tags)
        if tags and (prefix or len(tags) > 1):
            body += (f"<Filter><And><Prefix>{prefix}</Prefix>{tag_xml}"
                     "</And></Filter>")
        elif tags:
            body += f"<Filter>{tag_xml}</Filter>"
        else:
            body += f"<Filter><Prefix>{prefix}</Prefix></Filter>"
        days, nc, ab = draw(_DAYS), draw(_DAYS), draw(_DAYS)
        date = draw(st.one_of(st.none(), st.sampled_from([
            "2020-01-01T00:00:00Z", "2026-03-01T00:00:00Z",
            "2030-12-31T00:00:00Z"])))
        marker = draw(st.booleans())
        exp = ""
        if days:
            exp += f"<Days>{days}</Days>"
        elif date:
            exp += f"<Date>{date}</Date>"
        if marker:
            exp += "<ExpiredObjectDeleteMarker>true</ExpiredObjectDeleteMarker>"
        if exp:
            body += f"<Expiration>{exp}</Expiration>"
        if nc:
            body += ("<NoncurrentVersionExpiration><NoncurrentDays>"
                     f"{nc}</NoncurrentDays></NoncurrentVersionExpiration>")
        if ab:
            body += ("<AbortIncompleteMultipartUpload><DaysAfterInitiation>"
                     f"{ab}</DaysAfterInitiation>"
                     "</AbortIncompleteMultipartUpload>")
        rules.append(_rule(body))
    return _lc(*rules)


@settings(max_examples=80, deadline=None)
@given(_rules_xml(), st.integers(0, 2**31))
def test_lifecycle_grammar_hypothesis(doc, seed):
    """Any rule set from the grammar: the same parse, the same bytes
    out, and the same action for a handful of objects."""
    got = _outcome(tlc.Lifecycle.from_xml, doc.encode())
    want = _outcome(jlc.Lifecycle.from_xml, doc.encode())
    assert (got[0], got[1:] if got[0] == "err" else None) == \
        (want[0], want[1:] if want[0] == "err" else None)
    if got[0] != "ok":
        return
    assert got[1].to_xml() == want[1].to_xml()
    for topts, jopts, now in _opts_grid(seed, 12):
        assert got[1].compute_action(topts, now) == \
            want[1].compute_action(jopts, now)


def _opts_grid(seed: int, n: int):
    """n (port ObjectOpts, JAX ObjectOpts, now_ns) triples from a seed."""
    rng = np.random.default_rng(seed)
    names = ["a/x", "logs/1", "logs/deep/2", "up/p", "x", "ü/k", "other"]
    tag_forms = ["", "a=1", "a=1&b=2", "b=2", "a=2&c=1", "t=1"]
    out = []
    for _ in range(n):
        mod = NOW_NS - int(rng.integers(0, 800)) * DAY_NS // 2
        fields = dict(
            name=names[rng.integers(len(names))],
            mod_time_ns=int(mod) if rng.random() > 0.1 else 0,
            is_latest=bool(rng.random() > 0.3),
            delete_marker=bool(rng.random() > 0.8),
            num_versions=int(rng.integers(1, 4)),
            user_tags=tag_forms[rng.integers(len(tag_forms))],
            successor_mod_time_ns=(
                int(mod + int(rng.integers(0, 40)) * DAY_NS)
                if rng.random() > 0.5 else 0
            ),
        )
        now = NOW_NS + int(rng.integers(-5, 900)) * DAY_NS
        out.append((tlc.ObjectOpts(**fields), jlc.ObjectOpts(**fields), now))
    return out


@pytest.mark.parametrize("name", sorted(
    n for n in LC_DOCS
    if _outcome(jlc.Lifecycle.from_xml, LC_DOCS[n].encode())[0] == "ok"))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_action_grid(name, seed):
    tl = tlc.Lifecycle.from_xml(LC_DOCS[name].encode())
    jl = jlc.Lifecycle.from_xml(LC_DOCS[name].encode())
    actions = []
    for topts, jopts, now in _opts_grid(seed, 200):
        got, want = tl.compute_action(topts, now), jl.compute_action(jopts, now)
        assert got == want, (topts, now)
        actions.append(got)
        for key in (topts.name, "up/x", "none"):
            assert tl.abort_multipart_before_ns(key, now) == \
                jl.abort_multipart_before_ns(key, now)
    if name in ("days", "date", "noncurrent", "two_rules"):
        assert set(actions) - {tlc.Action.NONE}, "the grid never fires"


def test_compute_action_constants_match():
    for attr in ("NONE", "DELETE", "DELETE_VERSION", "ABORT_MULTIPART"):
        assert getattr(tlc.Action, attr) == getattr(jlc.Action, attr)


# -- object lock -----------------------------------------------------------

LOCK_DOCS = {
    "enabled": f"<ObjectLockConfiguration {NS}><ObjectLockEnabled>Enabled"
               "</ObjectLockEnabled></ObjectLockConfiguration>",
    "bare": "<ObjectLockConfiguration/>",
    "gov_days": "<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
                "</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE"
                "</Mode><Days>1</Days></DefaultRetention></Rule>"
                "</ObjectLockConfiguration>",
    "comp_years": "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>"
                  "COMPLIANCE</Mode><Years>2</Years></DefaultRetention></Rule>"
                  "</ObjectLockConfiguration>",
    "bad_enabled": "<ObjectLockConfiguration><ObjectLockEnabled>Yes"
                   "</ObjectLockEnabled></ObjectLockConfiguration>",
    "bad_mode": "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>X"
                "</Mode><Days>1</Days></DefaultRetention></Rule>"
                "</ObjectLockConfiguration>",
    "both": "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>"
            "GOVERNANCE</Mode><Days>1</Days><Years>1</Years>"
            "</DefaultRetention></Rule></ObjectLockConfiguration>",
    "neither": "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>"
               "GOVERNANCE</Mode></DefaultRetention></Rule>"
               "</ObjectLockConfiguration>",
    "zero_days": "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>"
                 "GOVERNANCE</Mode><Days>0</Days></DefaultRetention></Rule>"
                 "</ObjectLockConfiguration>",
    "text_days": "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>"
                 "GOVERNANCE</Mode><Days>x</Days></DefaultRetention></Rule>"
                 "</ObjectLockConfiguration>",
    "wrong_root": "<Retention/>",
    "malformed": "<ObjectLockConfiguration>",
}


@pytest.mark.parametrize("name", sorted(LOCK_DOCS))
def test_object_lock_config_round_trip(name, fixed_clock):
    raw = LOCK_DOCS[name].encode()
    got = _outcome(tlock.ObjectLockConfig.from_xml, raw)
    want = _outcome(jlock.ObjectLockConfig.from_xml, raw)
    if got[0] == "ok":
        assert want[0] == "ok"
        assert got[1].to_xml() == want[1].to_xml()
        assert got[1].default_retention_meta() == \
            want[1].default_retention_meta()
    else:
        assert got == want


RETENTION_DOCS = {
    "gov": "<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>"
           "2099-01-01T00:00:00Z</RetainUntilDate></Retention>",
    "comp_offset": f"<Retention {NS}><Mode>COMPLIANCE</Mode><RetainUntilDate>"
                   "2099-01-01T05:00:00+02:00</RetainUntilDate></Retention>",
    "frac": "<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>"
            "2099-01-01T00:00:00.250Z</RetainUntilDate></Retention>",
    "past": "<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>"
            "2020-01-01T00:00:00Z</RetainUntilDate></Retention>",
    "no_date": "<Retention><Mode>GOVERNANCE</Mode></Retention>",
    "bad_date": "<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>later"
                "</RetainUntilDate></Retention>",
    "bad_mode": "<Retention><Mode>gov</Mode><RetainUntilDate>"
                "2099-01-01T00:00:00Z</RetainUntilDate></Retention>",
    "wrong_root": "<LegalHold/>",
    "malformed": "<Retention>",
}


@pytest.mark.parametrize("name", sorted(RETENTION_DOCS))
def test_retention_round_trip(name, fixed_clock):
    raw = RETENTION_DOCS[name].encode()
    got = _outcome(tlock.Retention.from_xml, raw)
    want = _outcome(jlock.Retention.from_xml, raw)
    if got[0] == "ok":
        assert (got[1].mode, got[1].retain_until) == \
            (want[1].mode, want[1].retain_until)
        assert got[1].to_xml() == want[1].to_xml()
        meta = {tlock.META_MODE: got[1].mode,
                tlock.META_RETAIN_UNTIL: tlock.format_iso8601(
                    got[1].retain_until)}
        assert dataclasses.astuple(tlock.Retention.from_meta(meta)) == \
            dataclasses.astuple(jlock.Retention.from_meta(meta))
    else:
        assert got == want


@pytest.mark.parametrize("doc", [
    "<LegalHold><Status>ON</Status></LegalHold>",
    f"<LegalHold {NS}><Status>OFF</Status></LegalHold>",
    "<LegalHold><Status>on</Status></LegalHold>",
    "<LegalHold/>", "<Retention/>", "<LegalHold>",
])
def test_legal_hold_round_trip(doc):
    got = _outcome(tlock.parse_legal_hold_xml, doc.encode())
    assert got == _outcome(jlock.parse_legal_hold_xml, doc.encode())
    if got[0] == "ok":
        assert tlock.legal_hold_xml(got[1]) == jlock.legal_hold_xml(got[1])


LOCK_HEADERS = [
    {},
    {"x-amz-object-lock-mode": "GOVERNANCE",
     "x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00Z"},
    {"X-Amz-Object-Lock-Mode": "compliance",
     "X-Amz-Object-Lock-Retain-Until-Date": "2099-06-01T00:00:00+01:00",
     "X-Amz-Object-Lock-Legal-Hold": "on"},
    {"x-amz-object-lock-legal-hold": "OFF"},
    {"x-amz-object-lock-legal-hold": "maybe"},
    {"x-amz-object-lock-mode": "GOVERNANCE"},
    {"x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00Z"},
    {"x-amz-object-lock-mode": "WORM",
     "x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00Z"},
    {"x-amz-object-lock-mode": "GOVERNANCE",
     "x-amz-object-lock-retain-until-date": "2020-01-01T00:00:00Z"},
    {"x-amz-object-lock-mode": "GOVERNANCE",
     "x-amz-object-lock-retain-until-date": "never"},
]


@pytest.mark.parametrize("i", range(len(LOCK_HEADERS)))
def test_lock_meta_from_headers(i, fixed_clock):
    h = LOCK_HEADERS[i]
    assert _outcome(tlock.retention_meta_from_headers, h) == \
        _outcome(jlock.retention_meta_from_headers, h)


@pytest.mark.parametrize("headers", [
    {}, {"x-amz-bypass-governance-retention": "true"},
    {"X-Amz-Bypass-Governance-Retention": " TRUE "},
    {"x-amz-bypass-governance-retention": "false"},
    {"x-amz-bypass-governance-retention": "yes"},
])
def test_governance_bypass_header(headers):
    assert tlock.is_governance_bypass(headers) == \
        jlock.is_governance_bypass(headers)


_FUTURE = "2099-01-01T00:00:00Z"
_PAST = "2020-01-01T00:00:00Z"
VERSION_META = {
    "none": {},
    "hold_on": {"x-amz-object-lock-legal-hold": "ON"},
    "hold_off": {"x-amz-object-lock-legal-hold": "OFF"},
    "gov_future": {"x-amz-object-lock-mode": "GOVERNANCE",
                   "x-amz-object-lock-retain-until-date": _FUTURE},
    "gov_past": {"x-amz-object-lock-mode": "GOVERNANCE",
                 "x-amz-object-lock-retain-until-date": _PAST},
    "comp_future": {"x-amz-object-lock-mode": "COMPLIANCE",
                    "x-amz-object-lock-retain-until-date": _FUTURE},
    "comp_past_hold": {"x-amz-object-lock-mode": "COMPLIANCE",
                       "x-amz-object-lock-retain-until-date": _PAST,
                       "x-amz-object-lock-legal-hold": "ON"},
    "bad_date": {"x-amz-object-lock-mode": "GOVERNANCE",
                 "x-amz-object-lock-retain-until-date": "soon"},
    "mode_only": {"x-amz-object-lock-mode": "GOVERNANCE"},
}


@pytest.mark.parametrize("bypass", [False, True])
@pytest.mark.parametrize("name", sorted(VERSION_META))
def test_retention_blocks_delete(name, bypass, fixed_clock):
    meta = VERSION_META[name]
    got = tlock.retention_blocks_delete(meta, bypass_governance=bypass)
    assert got == jlock.retention_blocks_delete(meta, bypass_governance=bypass)
    if name == "comp_future":
        assert got == "retention"  # COMPLIANCE never yields
    if name == "gov_future":
        assert got == (None if bypass else "retention")


# -- quota -----------------------------------------------------------------

QUOTA_DOCS = [
    '{"quota": 1024, "quotatype": "hard"}', '{"quota": 5, "quotatype": "FIFO"}',
    '{"quota": "77"}', '{}', '{"quota": 0}', '{"quota": -1}',
    '{"quota": "x"}', '{"quota": 1, "quotatype": "soft"}', '[1]', 'nope',
    b'{"quota": 9, "quotatype": "fifo", "extra": true}',
]


@pytest.mark.parametrize("i", range(len(QUOTA_DOCS)))
def test_quota_json_round_trip(i):
    raw = QUOTA_DOCS[i]
    got = _outcome(tquota.QuotaConfig.from_json, raw)
    want = _outcome(jquota.QuotaConfig.from_json, raw)
    if got[0] == "ok":
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
        assert got[1].to_json() == want[1].to_json()
    else:
        assert got == want


class _Meta:
    def __init__(self, quota_json):
        self.quota_json = quota_json

    def get(self, bucket):
        if bucket == "missing":
            raise LookupError(bucket)
        return types.SimpleNamespace(quota_json=self.quota_json)


@pytest.mark.parametrize("doc", ["", '{"quota": 100}', '{"quota": 0}',
                                 '{"quota": 10, "quotatype": "fifo"}',
                                 "garbage"])
@pytest.mark.parametrize("bucket", ["b", "missing"])
def test_quota_config_for(doc, bucket):
    t = tquota.config_for(_Meta(doc), bucket)
    j = jquota.config_for(_Meta(doc), bucket)
    assert (t and dataclasses.asdict(t)) == (j and dataclasses.asdict(j))


def _fake_server(quota_json, sizes, snapshot=None, page=3):
    """A server stand-in: bucket_meta, a paged listing of ``sizes``
    (None marks a directory entry) and, optionally, a crawler whose
    snapshot says ``snapshot`` bytes."""
    objs = [types.SimpleNamespace(name=f"k{i:03d}", size=s or 0,
                                  is_dir=s is None)
            for i, s in enumerate(sizes)]

    def list_objects(bucket, prefix, marker, delimiter, max_keys):
        rest = [o for o in objs if o.name > marker][:page]
        more = bool(rest) and rest[-1].name != objs[-1].name
        return types.SimpleNamespace(objects=rest, is_truncated=more,
                                     next_marker=rest[-1].name if more else "")

    crawler = None
    if snapshot is not None:
        usage = types.SimpleNamespace(
            buckets={"b": types.SimpleNamespace(size=snapshot)})
        crawler = types.SimpleNamespace(usage=lambda: usage)
    return types.SimpleNamespace(
        bucket_meta=_Meta(quota_json), crawler=crawler,
        object_layer=types.SimpleNamespace(list_objects=list_objects))


@pytest.mark.parametrize("snapshot", [None, 0, 5000])
@pytest.mark.parametrize("add", [0, 1, 100, -3])
@pytest.mark.parametrize("doc", ['{"quota": 1000}', '{"quota": 10000}',
                                 '{"quota": 10, "quotatype": "fifo"}', ""])
def test_quota_enforce_put(doc, add, snapshot):
    sizes = [100, None, 250, 300, 50, None, 199]
    srv = _fake_server(doc, sizes, snapshot)
    assert tquota.bucket_size(srv, "b") == jquota.bucket_size(srv, "b")
    if snapshot is None:
        assert tquota.bucket_size(srv, "b") == 899  # the walk
    got = _outcome(tquota.enforce_put, srv, "b", add)
    want = _outcome(jquota.enforce_put, srv, "b", add)
    assert got == want
    if got[0] == "err":
        assert got[1] == "S3Error"
    for mod, err in ((tquota, TS3Error), (jquota, JS3Error)):
        try:
            mod.enforce_put(srv, "b", add)
        except err as e:
            assert e.err.code == "XMinioAdminBucketQuotaExceeded"
