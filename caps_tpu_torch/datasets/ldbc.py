"""Deterministic LDBC-SNB-like social network generator + interactive reads.

Benchmark configs 2/3 (BASELINE.md): the real LDBC-SNB datagen is a Spark
job that needs a cluster and a download, so this module generates a
structurally equivalent graph — Person/City/Forum/Post/Comment/Tag/Company
nodes with KNOWS/IS_LOCATED_IN/HAS_CREATOR/CONTAINER_OF/HAS_MODERATOR/
REPLY_OF/HAS_TAG/WORK_AT/LIKES edges, power-law-ish degree —
deterministically from a seed, parameterized by ``scale`` (scale 1.0 ≈ 1k
persons; LDBC SF1 is ~11k persons ⇒ scale 11).

Short reads IS1–IS7 and ALL 14 complex reads IC1–IC14 are provided as
Cypher strings with parameter makers.  IC1/IC2/IC7/IC8/IC9/IC11 follow the
official shapes (minus out-of-schema filters); the rest are explicitly
"-flavoured" — same operator skeleton, in-schema entities — with the
deviation noted inline per query.  Two adaptations are forced by engine
scope (SURVEY.md §7 "Hard parts" #5 — var-expand is bounded under jit):

* unbounded ``[:REPLY_OF*0..]`` reply-chains are bounded to ``*0..{D}``
  where D = ``MAX_REPLY_DEPTH`` — the generator never builds deeper chains,
  so results are exact for generated data;
* IC13/IC14's unbounded path searches are bounded to ``KNOWS*1..3``
  (beyond the bound IC13 returns null, LDBC's "-1" analog).

Reference analog: the reference ships no LDBC module; these configs come
from BASELINE.json (see BASELINE.md).

This is the port's copy of the JAX package's ``caps_tpu/datasets/ldbc.py``:
the same generator, graph builder and reads, so both packages build the
same graph from the same seed.  The JAX package's benchmark runner
(``run_ldbc_bench``) is not copied; the port's benchmark is a later
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np

from caps_tpu_torch.okapi.types import CTInteger, CTString
from caps_tpu_torch.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)

# Reply chains (Comment -REPLY_OF-> Comment -...-> Post) are generated with
# at most this many Comment hops, and the IS2/IS6 queries use *0..D bounds.
MAX_REPLY_DEPTH = 2

_FIRST = ["Jan", "Yang", "Aditi", "Carmen", "Kenji", "Lena", "Omar", "Priya",
          "Sam", "Tunde", "Vera", "Wei"]
_LAST = ["Ali", "Brown", "Chen", "Diallo", "Evans", "Fischer", "Garcia",
         "Haddad", "Ivanov", "Jones"]
_BROWSERS = ["Firefox", "Chrome", "Safari", "Opera"]
_CITIES = ["Leiden", "Malmo", "Austin", "Kyoto", "Accra", "Lima", "Pune",
           "Oslo", "Quito", "Taipei", "Bergen", "Sofia"]
_TAGS = ["jazz", "chess", "cycling", "poetry", "robotics", "sourdough",
         "astronomy", "bouldering", "gardens", "typography"]
_COMPANIES = ["Acme", "Globex", "Initech", "Umbra", "Vandelay", "Wonka",
              "Tyrell", "Soylent"]


@dataclasses.dataclass
class LdbcData:
    """Raw generated arrays, kept so tests can compute expected answers
    directly with numpy instead of trusting the engine under test."""
    person_ids: np.ndarray          # external ids (property `id`)
    person_first: List[str]
    person_last: List[str]
    person_city: np.ndarray         # index into city arrays
    person_birthday: np.ndarray
    person_creation: np.ndarray
    city_ids: np.ndarray
    city_names: List[str]
    forum_ids: np.ndarray
    forum_titles: List[str]
    forum_moderator: np.ndarray     # person index
    post_ids: np.ndarray
    post_creator: np.ndarray        # person index
    post_forum: np.ndarray          # forum index
    post_creation: np.ndarray
    comment_ids: np.ndarray
    comment_creator: np.ndarray     # person index
    comment_parent_post: np.ndarray   # -1 if replying to a comment
    comment_parent_comment: np.ndarray  # -1 if replying to a post
    comment_root_post: np.ndarray   # transitive root post index
    comment_creation: np.ndarray
    knows_src: np.ndarray           # person index pairs, both directions NOT
    knows_dst: np.ndarray           # materialized; KNOWS is matched undirected
    knows_creation: np.ndarray
    tag_ids: np.ndarray
    tag_names: List[str]
    post_tag_post: np.ndarray       # post index  -> HAS_TAG
    post_tag_tag: np.ndarray        # tag index
    company_ids: np.ndarray
    company_names: List[str]
    work_person: np.ndarray         # person index -> WORK_AT
    work_company: np.ndarray        # company index
    work_from: np.ndarray           # year
    likes_person: np.ndarray        # person index -> LIKES
    likes_is_post: np.ndarray       # bool: target in post space or comment
    likes_target: np.ndarray        # post/comment index
    likes_creation: np.ndarray


def _make_data(scale: float, seed: int) -> LdbcData:
    rng = np.random.RandomState(seed)
    n_person = max(16, int(round(1000 * scale)))
    n_city = min(len(_CITIES), max(4, n_person // 40))
    n_forum = max(4, n_person // 4)
    n_post = n_person * 4
    n_comment = n_post * 2

    # External id spaces mimic LDBC: persons/forums/messages disjoint.
    person_ids = np.arange(n_person, dtype=np.int64) + 10_000
    city_ids = np.arange(n_city, dtype=np.int64) + 600
    forum_ids = np.arange(n_forum, dtype=np.int64) + 50_000
    post_ids = np.arange(n_post, dtype=np.int64) + 1_000_000
    comment_ids = np.arange(n_comment, dtype=np.int64) + 2_000_000

    person_first = [_FIRST[i % len(_FIRST)] for i in range(n_person)]
    person_last = [_LAST[(i * 7) % len(_LAST)] for i in range(n_person)]
    person_city = rng.randint(0, n_city, n_person)
    person_birthday = rng.randint(19500101, 20051231, n_person).astype(np.int64)
    person_creation = rng.randint(20100101, 20230101, n_person).astype(np.int64)

    forum_moderator = rng.randint(0, n_person, n_forum)

    # Power-law-ish creator popularity: a few prolific authors.
    author_weight = 1.0 / (1.0 + np.arange(n_person))
    author_weight /= author_weight.sum()
    post_creator = rng.choice(n_person, n_post, p=author_weight)
    post_forum = rng.randint(0, n_forum, n_post)
    post_creation = rng.randint(20100101, 20230101, n_post).astype(np.int64)

    comment_creator = rng.choice(n_person, n_comment, p=author_weight)
    comment_creation = rng.randint(20100101, 20230101, n_comment).astype(np.int64)
    comment_parent_post = np.full(n_comment, -1, dtype=np.int64)
    comment_parent_comment = np.full(n_comment, -1, dtype=np.int64)
    comment_root_post = np.zeros(n_comment, dtype=np.int64)
    comment_depth = np.zeros(n_comment, dtype=np.int64)
    for i in range(n_comment):
        # Reply to an earlier comment (staying under MAX_REPLY_DEPTH) or a post.
        if i > 0 and rng.rand() < 0.4:
            j = rng.randint(0, i)
            if comment_depth[j] + 1 < MAX_REPLY_DEPTH:
                comment_parent_comment[i] = j
                comment_root_post[i] = comment_root_post[j]
                comment_depth[i] = comment_depth[j] + 1
                continue
        p = rng.randint(0, n_post)
        comment_parent_post[i] = p
        comment_root_post[i] = p
        comment_depth[i] = 0

    # KNOWS: preferential-attachment-flavoured pairs, deduped, no loops.
    n_knows = n_person * 8
    a = rng.choice(n_person, n_knows, p=author_weight)
    b = rng.randint(0, n_person, n_knows)
    keep = a != b
    a, b = a[keep], b[keep]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    knows_src, knows_dst = pairs[:, 0], pairs[:, 1]
    knows_creation = rng.randint(20100101, 20230101,
                                 len(knows_src)).astype(np.int64)

    # Tags on posts (IC6/IC12 shapes): 1-2 tags per post.
    n_tag = min(len(_TAGS), max(4, n_person // 50))
    tag_ids = np.arange(n_tag, dtype=np.int64) + 900
    pt_one = np.arange(n_post)
    pt_two = np.where(rng.rand(n_post) < 0.4)[0]  # 40% get a second tag
    post_tag_post = np.concatenate([pt_one, pt_two])
    t1 = rng.randint(0, n_tag, n_post)
    t2 = (t1[pt_two] + 1 + rng.randint(0, max(1, n_tag - 1),
                                       len(pt_two))) % n_tag
    post_tag_tag = np.concatenate([t1, t2])

    # Employment (IC11): ~80% of persons hold one job.
    n_company = min(len(_COMPANIES), max(3, n_person // 60))
    company_ids = np.arange(n_company, dtype=np.int64) + 40_000
    employed = np.where(rng.rand(n_person) < 0.8)[0]
    work_person = employed
    work_company = rng.randint(0, n_company, len(employed))
    work_from = rng.randint(1995, 2023, len(employed)).astype(np.int64)

    # Likes (IC7): person-LIKES->message with its own timestamp.
    n_likes = n_person * 6
    likes_person = rng.choice(n_person, n_likes, p=author_weight)
    likes_is_post = rng.rand(n_likes) < 0.65
    likes_target = np.where(likes_is_post,
                            rng.randint(0, n_post, n_likes),
                            rng.randint(0, n_comment, n_likes))
    likes_creation = rng.randint(20100101, 20230101, n_likes).astype(np.int64)

    return LdbcData(
        person_ids, person_first, person_last, person_city, person_birthday,
        person_creation, city_ids, [str(c) for c in _CITIES[:n_city]],
        forum_ids, [f"Forum {i}" for i in range(n_forum)], forum_moderator,
        post_ids, post_creator, post_forum, post_creation,
        comment_ids, comment_creator, comment_parent_post,
        comment_parent_comment, comment_root_post, comment_creation,
        knows_src, knows_dst, knows_creation,
        tag_ids, [str(t) for t in _TAGS[:n_tag]], post_tag_post, post_tag_tag,
        company_ids, [str(c) for c in _COMPANIES[:n_company]],
        work_person, work_company, work_from,
        likes_person, likes_is_post, likes_target, likes_creation)


def build_graph(session, scale: float = 0.05, seed: int = 7):
    """Generate data and register it as a property graph on ``session``.

    Returns ``(graph, LdbcData)``.  Posts/Comments carry the extra label
    ``Message`` so ``MATCH (m:Message)`` scans both tables, mirroring the
    LDBC schema's Message supertype.
    """
    d = _make_data(scale, seed)
    f = session.table_factory
    nid = iter(range(0, 1 << 40))  # internal node-id allocator

    def take(n):
        return [next(nid) for _ in range(n)]

    person_nid = np.array(take(len(d.person_ids)))
    city_nid = np.array(take(len(d.city_ids)))
    forum_nid = np.array(take(len(d.forum_ids)))
    post_nid = np.array(take(len(d.post_ids)))
    comment_nid = np.array(take(len(d.comment_ids)))
    tag_nid = np.array(take(len(d.tag_ids)))
    company_nid = np.array(take(len(d.company_ids)))

    def ints(a):
        return [int(x) for x in a]

    nodes = [
        NodeTable(
            NodeMapping.on().with_implied_labels("Person")
            .with_property("id").with_property("firstName")
            .with_property("lastName").with_property("birthday")
            .with_property("creationDate"),
            f.from_columns(
                {"_id": ints(person_nid), "id": ints(d.person_ids),
                 "firstName": d.person_first, "lastName": d.person_last,
                 "birthday": ints(d.person_birthday),
                 "creationDate": ints(d.person_creation)},
                {"_id": CTInteger, "id": CTInteger, "firstName": CTString,
                 "lastName": CTString, "birthday": CTInteger,
                 "creationDate": CTInteger})),
        NodeTable(
            NodeMapping.on().with_implied_labels("City")
            .with_property("id").with_property("name"),
            f.from_columns(
                {"_id": ints(city_nid), "id": ints(d.city_ids),
                 "name": d.city_names},
                {"_id": CTInteger, "id": CTInteger, "name": CTString})),
        NodeTable(
            NodeMapping.on().with_implied_labels("Forum")
            .with_property("id").with_property("title"),
            f.from_columns(
                {"_id": ints(forum_nid), "id": ints(d.forum_ids),
                 "title": d.forum_titles},
                {"_id": CTInteger, "id": CTInteger, "title": CTString})),
        NodeTable(
            NodeMapping.on().with_implied_labels("Message", "Post")
            .with_property("id").with_property("creationDate"),
            f.from_columns(
                {"_id": ints(post_nid), "id": ints(d.post_ids),
                 "creationDate": ints(d.post_creation)},
                {"_id": CTInteger, "id": CTInteger,
                 "creationDate": CTInteger})),
        NodeTable(
            NodeMapping.on().with_implied_labels("Message", "Comment")
            .with_property("id").with_property("creationDate"),
            f.from_columns(
                {"_id": ints(comment_nid), "id": ints(d.comment_ids),
                 "creationDate": ints(d.comment_creation)},
                {"_id": CTInteger, "id": CTInteger,
                 "creationDate": CTInteger})),
        NodeTable(
            NodeMapping.on().with_implied_labels("Tag")
            .with_property("id").with_property("name"),
            f.from_columns(
                {"_id": ints(tag_nid), "id": ints(d.tag_ids),
                 "name": d.tag_names},
                {"_id": CTInteger, "id": CTInteger, "name": CTString})),
        NodeTable(
            NodeMapping.on().with_implied_labels("Company")
            .with_property("id").with_property("name"),
            f.from_columns(
                {"_id": ints(company_nid), "id": ints(d.company_ids),
                 "name": d.company_names},
                {"_id": CTInteger, "id": CTInteger, "name": CTString})),
    ]

    rid = iter(range(1 << 40, 1 << 41))  # rel ids in their own space

    def rel(rtype, src_nids, tgt_nids, props=None, prop_types=None):
        n = len(src_nids)
        cols = {"_id": [next(rid) for _ in range(n)],
                "_src": ints(src_nids), "_tgt": ints(tgt_nids)}
        types = {"_id": CTInteger, "_src": CTInteger, "_tgt": CTInteger}
        mapping = RelationshipMapping.on(rtype)
        for key, vals in (props or {}).items():
            cols[key] = vals
            types[key] = prop_types[key]
            mapping = mapping.with_property(key)
        return RelationshipTable(mapping, f.from_columns(cols, types))

    has_parent_c = d.comment_parent_comment >= 0
    rels = [
        rel("KNOWS", person_nid[d.knows_src], person_nid[d.knows_dst],
            {"creationDate": ints(d.knows_creation)},
            {"creationDate": CTInteger}),
        rel("IS_LOCATED_IN", person_nid, city_nid[d.person_city]),
        rel("HAS_MODERATOR", forum_nid, person_nid[d.forum_moderator]),
        rel("CONTAINER_OF", forum_nid[d.post_forum], post_nid),
        rel("HAS_CREATOR", np.concatenate([post_nid,
                                           comment_nid]),
            np.concatenate([person_nid[d.post_creator],
                            person_nid[d.comment_creator]])),
        rel("REPLY_OF",
            np.concatenate([comment_nid[~has_parent_c],
                            comment_nid[has_parent_c]]),
            np.concatenate([post_nid[d.comment_parent_post[~has_parent_c]],
                            comment_nid[d.comment_parent_comment[has_parent_c]]])),
        rel("HAS_TAG", post_nid[d.post_tag_post], tag_nid[d.post_tag_tag]),
        rel("WORK_AT", person_nid[d.work_person],
            company_nid[d.work_company],
            {"workFrom": ints(d.work_from)}, {"workFrom": CTInteger}),
        rel("LIKES", person_nid[d.likes_person],
            np.where(d.likes_is_post,
                     post_nid[np.minimum(d.likes_target,
                                         len(post_nid) - 1)],
                     comment_nid[np.minimum(d.likes_target,
                                            len(comment_nid) - 1)]),
            {"creationDate": ints(d.likes_creation)},
            {"creationDate": CTInteger}),
    ]
    return session.create_graph(nodes, rels), d


# ---------------------------------------------------------------------------
# Interactive short reads IS1–IS7 (config 2).  Each entry:
#   name -> (cypher, param_maker(LdbcData, rng) -> params)
# ---------------------------------------------------------------------------

def _rand_person(d: LdbcData, rng) -> int:
    return int(d.person_ids[rng.randint(0, len(d.person_ids))])


def _rand_message(d: LdbcData, rng) -> int:
    if rng.rand() < 0.5:
        return int(d.post_ids[rng.randint(0, len(d.post_ids))])
    return int(d.comment_ids[rng.randint(0, len(d.comment_ids))])


SHORT_READS: Dict[str, Tuple[str, Callable[[LdbcData, Any], Mapping[str, Any]]]] = {
    "IS1": (
        "MATCH (n:Person {id: $personId})-[:IS_LOCATED_IN]->(c:City) "
        "RETURN n.firstName AS firstName, n.lastName AS lastName, "
        "n.birthday AS birthday, c.id AS cityId, "
        "n.creationDate AS creationDate",
        lambda d, rng: {"personId": _rand_person(d, rng)}),
    "IS2": (
        "MATCH (:Person {id: $personId})<-[:HAS_CREATOR]-(m:Message) "
        f"MATCH (m)-[:REPLY_OF*0..{MAX_REPLY_DEPTH}]->(p:Post) "
        "MATCH (p)-[:HAS_CREATOR]->(c:Person) "
        "RETURN m.id AS messageId, m.creationDate AS messageCreationDate, "
        "p.id AS originalPostId, c.id AS originalPostAuthorId, "
        "c.firstName AS originalPostAuthorFirst "
        "ORDER BY messageCreationDate DESC, messageId DESC LIMIT 10",
        lambda d, rng: {"personId": _rand_person(d, rng)}),
    "IS3": (
        "MATCH (n:Person {id: $personId})-[r:KNOWS]-(f:Person) "
        "RETURN f.id AS personId, f.firstName AS firstName, "
        "f.lastName AS lastName, r.creationDate AS friendshipCreationDate "
        "ORDER BY friendshipCreationDate DESC, personId ASC",
        lambda d, rng: {"personId": _rand_person(d, rng)}),
    "IS4": (
        "MATCH (m:Message {id: $messageId}) "
        "RETURN m.creationDate AS messageCreationDate, m.id AS messageId",
        lambda d, rng: {"messageId": _rand_message(d, rng)}),
    "IS5": (
        "MATCH (m:Message {id: $messageId})-[:HAS_CREATOR]->(p:Person) "
        "RETURN p.id AS personId, p.firstName AS firstName, "
        "p.lastName AS lastName",
        lambda d, rng: {"messageId": _rand_message(d, rng)}),
    "IS6": (
        "MATCH (m:Message {id: $messageId})"
        f"-[:REPLY_OF*0..{MAX_REPLY_DEPTH}]->(p:Post)"
        "<-[:CONTAINER_OF]-(f:Forum)-[:HAS_MODERATOR]->(mod:Person) "
        "RETURN f.id AS forumId, f.title AS forumTitle, "
        "mod.id AS moderatorId, mod.firstName AS moderatorFirstName",
        lambda d, rng: {"messageId": _rand_message(d, rng)}),
    "IS7": (
        "MATCH (m:Message {id: $messageId})<-[:REPLY_OF]-(c:Comment)"
        "-[:HAS_CREATOR]->(p:Person) "
        "MATCH (m)-[:HAS_CREATOR]->(a:Person) "
        "OPTIONAL MATCH (a)-[k:KNOWS]-(p) "
        "RETURN c.id AS commentId, c.creationDate AS commentCreationDate, "
        "p.id AS replyAuthorId, p.firstName AS replyAuthorFirstName, "
        "k IS NOT NULL AS replyAuthorKnowsOriginalMessageAuthor "
        "ORDER BY commentCreationDate DESC, replyAuthorId ASC",
        lambda d, rng: {"messageId": _rand_message(d, rng)}),
}


# ---------------------------------------------------------------------------
# Complex-read subset (config 3).  IC1/IC2/IC6-flavoured: var-expand,
# aggregation, multi-key ORDER BY.  IC numbering kept for judge parity;
# predicates simplified where they need Cypher features outside engine
# scope are noted inline.
# ---------------------------------------------------------------------------

COMPLEX_READS: Dict[str, Tuple[str, Callable[[LdbcData, Any], Mapping[str, Any]]]] = {
    # IC1: friends (up to 3 hops) with a given first name.
    "IC1": (
        "MATCH (p:Person {id: $personId})-[:KNOWS*1..3]-(f:Person) "
        "WHERE f.firstName = $firstName AND p.id <> f.id "
        "RETURN DISTINCT f.id AS friendId, f.lastName AS friendLastName "
        "ORDER BY friendId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "firstName": _FIRST[rng.randint(0, len(_FIRST))]}),
    # IC2: recent messages by direct friends.
    "IC2": (
        "MATCH (:Person {id: $personId})-[:KNOWS]-(f:Person)"
        "<-[:HAS_CREATOR]-(m:Message) "
        "WHERE m.creationDate <= $maxDate "
        "RETURN f.id AS personId, f.firstName AS personFirstName, "
        "m.id AS messageId, m.creationDate AS messageCreationDate "
        "ORDER BY messageCreationDate DESC, messageId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "maxDate": 20200101}),
    # IC3-flavoured: friends within 2 hops located in a given city
    # (LDBC IC3 counts messages from two countries in a date window; we
    # have City but no Country/date-windowed messages per person — the
    # traversal shape Person-KNOWS*1..2 + IS_LOCATED_IN is preserved).
    "IC3": (
        "MATCH (s:Person {id: $personId})-[:KNOWS*1..2]-(f:Person)"
        "-[:IS_LOCATED_IN]->(c:City {name: $cityName}) "
        "WHERE s.id <> f.id "
        "RETURN DISTINCT f.id AS friendId, f.firstName AS firstName, "
        "f.lastName AS lastName ORDER BY friendId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "cityName": d.city_names[
                            rng.randint(0, len(d.city_names))]}),
    # IC4-flavoured: forums with posts created by direct friends inside a
    # date window, ranked by post count (LDBC IC4 ranks tags of friend
    # posts in a window; Forum is the in-schema analog of Tag).
    "IC4": (
        "MATCH (:Person {id: $personId})-[:KNOWS]-(f:Person)"
        "<-[:HAS_CREATOR]-(p:Post)<-[:CONTAINER_OF]-(fo:Forum) "
        "WHERE p.creationDate >= $minDate AND p.creationDate < $maxDate "
        "RETURN fo.title AS forumTitle, count(*) AS postCount "
        "ORDER BY postCount DESC, forumTitle ASC LIMIT 10",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "minDate": 20150101, "maxDate": 20200101}),
    # IC5-flavoured: forums where friends-of-friends posted after a date,
    # ranked by those posts (LDBC IC5 ranks groups joined after a date by
    # friend post count; we have no HAS_MEMBER, CONTAINER_OF stands in).
    "IC5": (
        "MATCH (s:Person {id: $personId})-[:KNOWS*1..2]-(f:Person)"
        "<-[:HAS_CREATOR]-(p:Post)<-[:CONTAINER_OF]-(fo:Forum) "
        "WHERE s.id <> f.id AND p.creationDate > $minDate "
        "RETURN fo.id AS forumId, fo.title AS forumTitle, "
        "count(*) AS postCount "
        "ORDER BY postCount DESC, forumId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "minDate": 20180101}),
    # IC6-flavoured: forums containing posts by friends-of-friends,
    # ranked by post count (LDBC IC6 ranks co-occurring tags; we have no
    # Tag entity — forums are the closest in-schema analog).
    "IC6": (
        "MATCH (s:Person {id: $personId})-[:KNOWS*1..2]-(f:Person)"
        "<-[:HAS_CREATOR]-(p:Post)<-[:CONTAINER_OF]-(fo:Forum) "
        "WHERE s.id <> f.id "
        "RETURN fo.title AS forumTitle, count(*) AS postCount "
        "ORDER BY postCount DESC, forumTitle ASC LIMIT 10",
        lambda d, rng: {"personId": _rand_person(d, rng)}),
    # IC8: recent replies to any of the person's messages (exact LDBC
    # shape: message<-REPLY_OF-comment-HAS_CREATOR->author).
    "IC8": (
        "MATCH (:Person {id: $personId})<-[:HAS_CREATOR]-(m:Message)"
        "<-[:REPLY_OF]-(c:Comment)-[:HAS_CREATOR]->(author:Person) "
        "RETURN author.id AS personId, author.firstName AS firstName, "
        "c.id AS commentId, c.creationDate AS commentCreationDate "
        "ORDER BY commentCreationDate DESC, commentId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng)}),
    # IC9: recent messages by friends within 2 hops before a date.
    "IC9": (
        "MATCH (s:Person {id: $personId})-[:KNOWS*1..2]-(f:Person)"
        "<-[:HAS_CREATOR]-(m:Message) "
        "WHERE s.id <> f.id AND m.creationDate < $maxDate "
        "RETURN f.id AS personId, f.firstName AS personFirstName, "
        "m.id AS messageId, m.creationDate AS messageCreationDate "
        "ORDER BY messageCreationDate DESC, messageId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "maxDate": 20200101}),
    # IC7: recent likes on the person's messages (exact LDBC shape:
    # message<-LIKES-liker, like timestamp from the relationship).
    "IC7": (
        "MATCH (:Person {id: $personId})<-[:HAS_CREATOR]-(m:Message)"
        "<-[l:LIKES]-(liker:Person) "
        "RETURN liker.id AS personId, liker.firstName AS firstName, "
        "l.creationDate AS likeTime, m.id AS messageId "
        "ORDER BY likeTime DESC, personId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng)}),
    # IC10-flavoured: friend-of-friend recommendation — strictly 2 hops
    # (no direct friendship, via NOT EXISTS), birthday window, ranked by
    # connection-path count (LDBC scores by posts/common interests; the
    # schema analog here is path multiplicity).
    "IC10": (
        "MATCH (s:Person {id: $personId})-[:KNOWS*2..2]-(fof:Person) "
        "WHERE fof.id <> s.id AND fof.birthday >= $minBday "
        "AND NOT EXISTS { (s)-[:KNOWS]-(fof) } "
        "RETURN fof.id AS personId, fof.firstName AS firstName, "
        "count(*) AS paths "
        "ORDER BY paths DESC, personId ASC LIMIT 10",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "minBday": 19700101}),
    # IC11: friends' jobs started before a year (exact LDBC shape minus
    # the country filter — companies here carry no country).
    "IC11": (
        "MATCH (s:Person {id: $personId})-[:KNOWS*1..2]-(f:Person)"
        "-[w:WORK_AT]->(c:Company) "
        "WHERE s.id <> f.id AND w.workFrom < $maxYear "
        "RETURN f.id AS personId, f.firstName AS firstName, "
        "c.name AS companyName, w.workFrom AS workFrom "
        "ORDER BY workFrom ASC, personId ASC, companyName DESC LIMIT 10",
        lambda d, rng: {"personId": _rand_person(d, rng),
                        "maxYear": 2015}),
    # IC12-flavoured: expert search — friends ranked by replies to posts
    # carrying a given tag (LDBC uses a TagClass hierarchy; single tag
    # here — the schema has tags but no class tree).
    # IC12: expert search — spec shape incl. the DISTINCT aggregates
    # (count(DISTINCT comment), collect(DISTINCT tag.name)); the spec's
    # TagClass hierarchy is out of schema, so all tags qualify.
    "IC12": (
        "MATCH (s:Person {id: $personId})-[:KNOWS]-(f:Person)"
        "<-[:HAS_CREATOR]-(c:Comment)-[:REPLY_OF]->(p:Post)"
        "-[:HAS_TAG]->(t:Tag) "
        "RETURN f.id AS personId, f.firstName AS firstName, "
        "count(DISTINCT c) AS replyCount, "
        "collect(DISTINCT t.name) AS tagNames "
        "ORDER BY replyCount DESC, personId ASC LIMIT 20",
        lambda d, rng: {"personId": _rand_person(d, rng)}),
    # IC13-flavoured: shortest path length between two persons, bounded
    # to 3 hops (LDBC is unbounded; the static-unroll engine bounds the
    # search — beyond the bound the answer is null, LDBC's -1 analog).
    "IC13": (
        "MATCH (a:Person {id: $person1Id})-[r:KNOWS*1..3]-"
        "(b:Person {id: $person2Id}) "
        "RETURN min(size(r)) AS shortestPathLength",
        lambda d, rng: {"person1Id": _rand_person(d, rng),
                        "person2Id": _rand_person(d, rng)}),
    # IC14-flavoured: connection-strength profile between two persons —
    # path count per length over bounded paths (LDBC 14 weights paths by
    # message interactions; path multiplicity is the in-schema analog).
    "IC14": (
        "MATCH (a:Person {id: $person1Id})-[r:KNOWS*1..3]-"
        "(b:Person {id: $person2Id}) "
        "RETURN size(r) AS pathLength, count(*) AS paths "
        "ORDER BY pathLength ASC",
        lambda d, rng: {"person1Id": _rand_person(d, rng),
                        "person2Id": _rand_person(d, rng)}),
}
