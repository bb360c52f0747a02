"""Message-type space (reference model: engine/proto/proto.go:19-139 -- a
uint16 enum in bands: core cluster traffic, a gate band whose sub-range is
redirected verbatim to clients, and gate<->client-only types).

Bands:
  * 1..999     core game<->dispatcher<->gate control + routing
  * 1000..1999 gate service band; 1001..1499 is the REDIRECT sub-band --
               the gate forwards these to the owning client without parsing
               the body (after reading the leading ClientID)
  * 2001..     gate<->client direct (handshake/heartbeat)

The port's copy of the JAX package's ``proto/msgtypes.py``.
"""

# -- registration / lifecycle (core band) ---------------------------------
MT_SET_GAME_ID = 1           # game -> disp: gid, restore?, entity id list
MT_SET_GATE_ID = 2           # gate -> disp: gate id
MT_NOTIFY_CREATE_ENTITY = 3  # game -> disp: eid (directory add)
MT_NOTIFY_DESTROY_ENTITY = 4
MT_NOTIFY_CLIENT_CONNECTED = 5     # gate -> disp: client id, boot eid
MT_NOTIFY_CLIENT_DISCONNECTED = 6  # gate -> disp -> owner game
MT_NOTIFY_DEPLOYMENT_READY = 7     # disp -> all: barrier passed
MT_NOTIFY_GAME_CONNECTED = 8
MT_NOTIFY_GAME_DISCONNECTED = 9
MT_NOTIFY_GATE_DISCONNECTED = 10
MT_REJECT_DUPLICATE_ENTITY = 11  # disp -> game: your claimed eid lives elsewhere

# -- cluster supervision: leases / epoch fencing / failover ----------------
# (docs/robustness.md "Cluster supervision & host failover")
MT_GAME_LEASE_GRANT = 12   # disp -> game: ownership epoch u32, lease ttl f32
MT_GAME_LEASE_RENEW = 13   # game -> disp: gid, epoch, checkpointed space ids
MT_GAME_SHUTDOWN = 14      # disp -> fenced zombie game: your epoch is stale,
                           # your spaces were re-homed -- terminate
MT_REHOME_SPACES = 15      # disp -> survivor game: dead gid, new epoch,
                           # space ids to restore from the checkpoint store
MT_REPLAY_MOVES = 16       # disp -> survivor game: dead gid, buffered client
                           # movement batches since the last consistent epoch

# -- cluster observability (docs/observability.md "Cluster metrics") -------
MT_METRICS_REPORT = 17     # gate/game -> disp: component name, versioned
                           # metric snapshot (games usually piggyback on
                           # MT_GAME_LEASE_RENEW instead; gates have no
                           # lease, so they send this)

# -- entity creation / RPC routing ----------------------------------------
MT_CREATE_ENTITY_ANYWHERE = 20  # game -> disp: type, attrs (LBC placement)
MT_LOAD_ENTITY_ANYWHERE = 21    # game -> disp: type, eid
MT_CALL_ENTITY_METHOD = 22      # any game -> disp -> owner game
MT_CALL_ENTITY_METHOD_FROM_CLIENT = 23  # client -> gate -> disp -> game
MT_CALL_NIL_SPACES = 24         # broadcast to all games' nil spaces
# id 25 retired (was MT_QUERY_SPACE_GAMEID, never implemented -- msg-flow);
# migration uses MT_QUERY_SPACE_GAMEID_FOR_MIGRATE.  Do not reuse the id.
MT_CALL_ENTITIES_BATCH = 26     # game -> disp -> games: one RPC, many eids
                                # (grouped fanout: pubsub publish etc.)

# -- migration (EnterSpace) ------------------------------------------------
MT_QUERY_SPACE_GAMEID_FOR_MIGRATE = 30
MT_MIGRATE_REQUEST = 31
MT_REAL_MIGRATE = 32
MT_CANCEL_MIGRATE = 33
MT_GIVE_CLIENT_TO = 34  # game -> disp (by target eid shard) -> target's game:
                        # target eid, client id, gate id (reference:
                        # Entity.go:752-765, GateService.go:263-294 -- the
                        # gate's owner switch rides the is_player create)

# -- service discovery -----------------------------------------------------
MT_SRVDIS_REGISTER = 40  # game -> disp: srvid, info
MT_SRVDIS_UPDATE = 41    # disp -> games: srvid, info ("" = deregistered)
MT_SRVDIS_SNAPSHOT = 42  # disp -> one game on connect: full shard registry;
                         # the game prunes its entries for that shard first

# -- freeze / hot reload ---------------------------------------------------
MT_START_FREEZE_GAME = 50      # game -> disp
MT_START_FREEZE_GAME_ACK = 51  # disp -> game

# -- position sync (batched at every hop) ---------------------------------
MT_SYNC_POSITION_YAW_FROM_CLIENT = 60  # gate -> disp -> game, flat records
MT_SYNC_POSITION_YAW_ON_CLIENTS = 61   # game -> disp -> gate, flat records

# -- load balancing --------------------------------------------------------
MT_GAME_LBC_INFO = 70  # game -> disp: cpu load fraction

# -- gate service band -----------------------------------------------------
MT_GATE_SERVICE_BEGIN = 1000
MT_REDIRECT_TO_CLIENT_BEGIN = 1001
MT_CREATE_ENTITY_ON_CLIENT = 1002        # + ClientID prefix, redirected
MT_DESTROY_ENTITY_ON_CLIENT = 1003
MT_NOTIFY_ATTR_CHANGE_ON_CLIENT = 1004   # attr delta
MT_CALL_ENTITY_METHOD_ON_CLIENT = 1005
MT_REDIRECT_TO_CLIENT_END = 1499
MT_CALL_FILTERED_CLIENTS = 1501          # game -> disp -> ALL gates
MT_SET_CLIENTPROXY_FILTER_PROP = 1502    # game -> disp -> owning gate
MT_CLEAR_CLIENTPROXY_FILTER_PROPS = 1503
MT_KICK_CLIENT = 1504                    # game/disp -> gate: close the client
#   connection (e.g. a GiveClientTo whose target never materialized -- the
#   ownerless client must reconnect rather than hang on a dead owner)
MT_GATE_SERVICE_END = 1999

# -- gate <-> client direct ------------------------------------------------
MT_CLIENT_HANDSHAKE = 2001  # gate -> client: your ClientID
MT_HEARTBEAT = 2002         # client -> gate

FILTER_OP_EQ = 0
FILTER_OP_NE = 1
FILTER_OP_LT = 2
FILTER_OP_LTE = 3
FILTER_OP_GT = 4
FILTER_OP_GTE = 5


def is_redirect_to_client(msgtype: int) -> bool:
    return MT_REDIRECT_TO_CLIENT_BEGIN <= msgtype <= MT_REDIRECT_TO_CLIENT_END


def is_gate_service(msgtype: int) -> bool:
    return MT_GATE_SERVICE_BEGIN <= msgtype <= MT_GATE_SERVICE_END
