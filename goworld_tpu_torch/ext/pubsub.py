"""Publish/subscribe service (reference: ext/pubsub/PublishSubscribeService.go
-- a cluster-singleton service entity holding a subject tree with trailing-*
wildcard subscriptions; state round-trips through attrs so it survives
freeze/restore).

Subjects are opaque strings; a subscription ending in ``*`` matches every
subject with that prefix (reference semantics).  Matching structure
(reference parity: the trie-TST at PublishSubscribeService.go:34-67):

  * exact subscriptions: hash map, O(1) per publish;
  * wildcard subscriptions: a character trie -- publish walks the subject
    once and collects subscriber sets at every node on the path, so the
    cost is O(len(subject)), independent of the number of wildcard
    subscriptions (the round-2 linear prefix scan was O(#wildcards)).

The attrs tree remains the persistent record (freeze/restore); the trie and
exact index are in-memory mirrors rebuilt on restore.

Fanout is BATCHED: one ``call_entities_batch`` per publish (one packet per
dispatcher shard, split per game by the dispatcher) instead of one
dispatcher packet per subscriber from the logic thread.
"""

from __future__ import annotations

from ..engine.entity import Entity
from ..engine.rpc import rpc


class _TrieNode:
    __slots__ = ("children", "eids")

    def __init__(self):
        self.children: dict[str, _TrieNode] = {}
        self.eids: set[str] = set()


class PublishSubscribeService(Entity):
    persistent = False

    def on_init(self):
        # attrs-backed so OnFreeze/OnRestored round-trips the subscriptions
        # (reference: PublishSubscribeService.go OnFreeze/OnRestored)
        self.attrs.get_map("exact")      # subject -> {eid: 1}
        self.attrs.get_map("wildcard")   # prefix  -> {eid: 1}
        self._rebuild_index()

    def on_restored(self):
        self._rebuild_index()

    def _rebuild_index(self):
        self._exact: dict[str, set[str]] = {}
        self._trie = _TrieNode()
        exact = self.attrs.get_map("exact")
        for subject in exact.keys():
            self._exact[subject] = set(exact.get_map(subject).keys())
        wild = self.attrs.get_map("wildcard")
        for prefix in wild.keys():
            node = self._trie_insert(prefix)
            node.eids.update(wild.get_map(prefix).keys())

    def _trie_insert(self, prefix: str) -> _TrieNode:
        node = self._trie
        for ch in prefix:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = node.children[ch] = _TrieNode()
            node = nxt
        return node

    @rpc
    def subscribe(self, eid: str, subject: str):
        tree, key = self._tree_key(subject)
        tree.get_map(key).set(eid, 1)
        if subject.endswith("*"):
            self._trie_insert(key).eids.add(eid)
        else:
            self._exact.setdefault(key, set()).add(eid)

    @rpc
    def unsubscribe(self, eid: str, subject: str):
        tree, key = self._tree_key(subject)
        if key in tree:
            subs = tree.get_map(key)
            if eid in subs:
                subs.delete(eid)
        if subject.endswith("*"):
            path = [self._trie]
            node = self._trie
            for ch in key:
                node = node.children.get(ch)
                if node is None:
                    return
                path.append(node)
            node.eids.discard(eid)
            # prune now-empty tail nodes so dead prefixes don't accumulate
            for i in range(len(path) - 1, 0, -1):
                n = path[i]
                if n.eids or n.children:
                    break
                del path[i - 1].children[key[i - 1]]
        else:
            subs2 = self._exact.get(key)
            if subs2 is not None:
                subs2.discard(eid)
                if not subs2:
                    del self._exact[key]

    @rpc
    def publish(self, subject: str, *args):
        targets: set[str] = set()
        exact = self._exact.get(subject)
        if exact:
            targets.update(exact)
        node = self._trie
        targets.update(node.eids)  # "*" alone: empty prefix matches all
        for ch in subject:
            node = node.children.get(ch)
            if node is None:
                break
            targets.update(node.eids)
        if not targets:
            return
        ordered = sorted(targets)
        game = getattr(self._runtime(), "game", None)
        if game is not None:
            game.call_entities_batch(ordered, "on_published", subject, *args)
        else:
            for eid in ordered:
                e = self.manager.get(eid)
                if e is not None:
                    e.call("on_published", subject, *args)

    def _tree_key(self, subject: str):
        if subject.endswith("*"):
            return self.attrs.get_map("wildcard"), subject[:-1]
        return self.attrs.get_map("exact"), subject
