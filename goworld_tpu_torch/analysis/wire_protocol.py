"""wire: consistency of the hand-maintained wire protocol.

The port's copy of the JAX package's rule.  The protocol has no schema compiler -- ``proto/msgtypes.py`` is a
hand-numbered enum, ``netutil/packet.py`` a hand-paired set of
append/read codecs, ``proto/connection.py`` hand-written senders.  All
three drift silently.  Derived from the AST (never from comments):

* MT_* ids must be unique, and each band must be declared in ascending
  id order (the file reads as a number line; an out-of-order entry is
  how duplicate ids get minted);
* every ``append_X`` on Packet must have a matching ``read_X`` (and vice
  versa), and a matching pair must agree on the struct codec it uses
  (``_u16.pack`` on one side, ``_u16.unpack`` on the other);
* every ``Packet.for_msgtype(MT.MT_X)`` call site -- in connection.py or
  any service -- must name a constant that exists in msgtypes.py;
* senders may only call append methods Packet actually defines;
* REDIRECT-band senders (ids inside MT_REDIRECT_TO_CLIENT_BEGIN..END)
  must open with ``append_u16`` (gate id) then ``append_client_id``: the
  dispatcher forwards these after reading ONLY the leading u16, and the
  gate then strips the client id -- any other prefix desyncs the stream.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, call_name, const_int, dotted

RULE = "wire"

_BANDS = ((1, 999), (1000, 1999), (2000, 1 << 16))


def _msgtype_constants(sf):
    """[(name, value, lineno)] for MT_* int assignments, in source order."""
    out = []
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name.startswith("MT_"):
                val = const_int(node.value)
                if val is not None:
                    out.append((name, val, node.lineno))
    return out


def _packet_codecs(sf):
    """(appends, reads, struct_use) from the Packet class.

    appends/reads map suffix -> lineno (aliases via class-level
    ``append_b = append_a`` count as definitions of the alias suffix);
    struct_use maps method name -> set of module-level struct names used.
    """
    appends: dict[str, int] = {}
    reads: dict[str, int] = {}
    struct_use: dict[str, set[str]] = {}
    struct_names = set()
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call) \
                and call_name(node.value).endswith("Struct"):
            struct_names.add(node.targets[0].id)
    for node in sf.nodes:
        if not isinstance(node, ast.ClassDef):
            continue
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                name = item.name
                if name.startswith("append_"):
                    appends[name[len("append_"):]] = item.lineno
                elif name.startswith("read_"):
                    reads[name[len("read_"):]] = item.lineno
                used = {dotted(n).split(".")[0] for n in ast.walk(item)
                        if isinstance(n, ast.Attribute)}
                struct_use[name] = used & struct_names
            elif isinstance(item, ast.Assign) and len(item.targets) == 1 \
                    and isinstance(item.targets[0], ast.Name) \
                    and isinstance(item.value, ast.Name):
                alias, target = item.targets[0].id, item.value.id
                if alias.startswith("append_") and target.startswith("append_"):
                    appends[alias[len("append_"):]] = item.lineno
                    struct_use[alias] = struct_use.get(target, set())
                elif alias.startswith("read_") and target.startswith("read_"):
                    reads[alias[len("read_"):]] = item.lineno
                    struct_use[alias] = struct_use.get(target, set())
    return appends, reads, struct_use


def _sender_streams(sf):
    """Per function: (lineno, mt_name, [append attr-names in call order]).

    A sender is any function whose body calls ``*.for_msgtype(<MT attr>)``.
    """
    out = []
    for fn in sf.nodes:
        if not isinstance(fn, ast.FunctionDef):
            continue
        mt_name = None
        appends: list[tuple[int, str]] = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr == "for_msgtype" and node.args:
                arg = node.args[0]
                nm = dotted(arg).rsplit(".", 1)[-1]
                if nm.startswith("MT_") and mt_name is None:
                    mt_name = nm
            elif node.func.attr.startswith("append_"):
                appends.append((node.lineno, node.func.attr))
        if mt_name is not None:
            appends.sort()
            out.append((fn.lineno, fn.name, mt_name,
                        [a for _, a in appends]))
    return out


def check(ctx: Context):
    mt_files = ctx.files_matching("proto/msgtypes.py")
    if not mt_files:
        return
    mtf = mt_files[0]
    consts = _msgtype_constants(mtf)
    by_name = {n: v for n, v, _ in consts}

    # 1. unique ids
    seen: dict[int, str] = {}
    for name, val, line in consts:
        if val in seen:
            yield Finding(RULE, mtf.rel, line, 0,
                          f"{name} = {val} duplicates {seen[val]}")
        else:
            seen[val] = name

    # 2. ascending declaration order within each band
    last: dict[tuple[int, int], tuple[str, int]] = {}
    for name, val, line in consts:
        band = next((b for b in _BANDS if b[0] <= val <= b[1]), None)
        if band is None:
            yield Finding(RULE, mtf.rel, line, 0,
                          f"{name} = {val} falls outside every protocol band")
            continue
        prev = last.get(band)
        if prev is not None and val < prev[1]:
            yield Finding(
                RULE, mtf.rel, line, 0,
                f"{name} = {val} declared after {prev[0]} = {prev[1]}: "
                "bands must read as an ascending number line")
        else:
            last[band] = (name, val)

    redirect_lo = by_name.get("MT_REDIRECT_TO_CLIENT_BEGIN")
    redirect_hi = by_name.get("MT_REDIRECT_TO_CLIENT_END")

    # 3. packet.py append/read symmetry
    pkt_files = ctx.files_matching("netutil/packet.py")
    known_appends: set[str] = set()
    for sf in pkt_files:
        appends, reads, struct_use = _packet_codecs(sf)
        known_appends = {f"append_{s}" for s in appends}
        for suffix, line in sorted(appends.items()):
            if suffix not in reads:
                yield Finding(RULE, sf.rel, line, 0,
                              f"append_{suffix} has no matching read_{suffix}")
        for suffix, line in sorted(reads.items()):
            if suffix not in appends:
                yield Finding(RULE, sf.rel, line, 0,
                              f"read_{suffix} has no matching append_{suffix}")
        for suffix in sorted(set(appends) & set(reads)):
            a_use = struct_use.get(f"append_{suffix}", set())
            r_use = struct_use.get(f"read_{suffix}", set())
            if a_use and r_use and a_use != r_use:
                yield Finding(
                    RULE, sf.rel, appends[suffix], 0,
                    f"append_{suffix}/read_{suffix} use different struct "
                    f"codecs ({sorted(a_use)} vs {sorted(r_use)}): the pair "
                    "is no longer field-symmetric")

    # 4. sender validation, everywhere for_msgtype appears
    for sf in ctx.files:
        if sf is mtf:
            continue
        for line, fname, mt_name, appends in _sender_streams(sf):
            if mt_name not in by_name:
                yield Finding(RULE, sf.rel, line, 0,
                              f"{fname} sends unknown msgtype {mt_name}")
                continue
            if known_appends:
                for a in appends:
                    if a not in known_appends:
                        yield Finding(
                            RULE, sf.rel, line, 0,
                            f"{fname} calls {a}() which Packet does not define")
            # the prefix contract binds the TYPED senders (connection.py);
            # a gate legitimately rebuilds redirect packets prefix-stripped
            # when forwarding to the owning client
            if sf.rel.endswith("proto/connection.py") \
                    and redirect_lo is not None and redirect_hi is not None \
                    and redirect_lo < by_name[mt_name] < redirect_hi:
                if appends[:2] != ["append_u16", "append_client_id"]:
                    yield Finding(
                        RULE, sf.rel, line, 0,
                        f"{fname}: redirect-band {mt_name} must open with "
                        "append_u16(gate_id) + append_client_id -- the "
                        "dispatcher/gate strip exactly that prefix")
