"""Direct DB access helpers for game code (reference role: ext/db --
gwmongo/gwredis async wrappers).  Here: a pure-python RESP (redis protocol)
client, an in-process mini-redis server for hermetic development/testing,
and async wrappers (gwredis / gwsql) whose callbacks re-enter the logic
thread via post, matching the reference's ext/db callback contract.  The mongo family
(``bson``, ``minimongo``, ``mongowire`` with its hermetic
``MiniMongoServer``, ``gwdoc``) and the mysql family (``mysqlwire`` with
its hermetic ``MiniMySQLServer``) speak the real wire protocols, so the
mongodb and mysql backends run without an external driver."""
