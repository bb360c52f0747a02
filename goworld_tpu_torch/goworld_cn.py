# -*- coding: utf-8 -*-
"""goworld_tpu_torch 中文 API 门面 (reference role: cn/goworld_cn.go — 与英文
门面逐函数对应的平行 API 面, 每个函数带中文说明).

进程模型与线程约定
==================

* **进程模型**: 一个集群由 1+ 个 dispatcher(消息路由), 1+ 个 game(实体
  逻辑), 1+ 个 gate(客户端接入)组成; game 和 gate 只连接 dispatcher,
  互相之间没有直接连接。
* **线程约定**: 每个 game 进程只有一个逻辑线程; 所有实体回调(RPC、定时
  器、AOI 事件)都在该线程执行, **回调中禁止阻塞**。其它线程(网络收包、
  存储)只通过 post 队列把结果送回逻辑线程。
* **Space 与 AOI**: Space 也是实体; ``enable_aoi(distance)`` 打开视野管
  理。视野事件(``on_enter_aoi`` / ``on_leave_aoi``)按 tick 批量计算 —
  在 cuda 后端下, 同容量的所有 Space 由手写的 CUDA 内核
  (``csrc/aoi_step.cu``) 在显卡上一次算完。
* **热更新**: ``cli reload`` 冻结所有实体状态(含 AOI 兴趣集)到磁盘并以
  ``-restore`` 重启 game, 客户端连接保持不断。

用法::

    from goworld_tpu_torch import goworld_cn as goworld

    class Avatar(goworld.Entity):
        use_aoi = True
        aoi_distance = 100.0

    def setup(game):
        goworld.注册实体(Avatar)       # 或 goworld.register_entity(Avatar)

英文名在本模块中同样可用 (从 :mod:`goworld_tpu_torch.goworld` 全量导入)。
"""

from __future__ import annotations

from typing import Callable

from .goworld import *  # noqa: F401,F403
from . import goworld as _gw
from .engine.entity import Entity
from .engine.vector import Vector3  # noqa: F401  (常用类型再导出)


def 运行(argv=None) -> int:
    """启动 game 进程主循环 (等价 ``goworld.run``; reference:
    goworld.Run, goworld.go:34-36).  解析 ``-gid/-configfile/-restore``
    等参数, 完成 存储/kvdb/crontab/集群连接 初始化后进入逻辑循环,
    阻塞直到进程退出。"""
    return _gw.run(argv)


def 注册实体(cls: type, name: str | None = None):
    """注册实体类型 (等价 ``register_entity``; reference:
    goworld.RegisterEntity).  必须在 ``run`` 前调用; ``name`` 缺省为类名。
    实体的 RPC 暴露级别用 ``@rpc(expose=...)`` 装饰器声明, 属性同步类别用
    ``client_attrs`` / ``all_client_attrs`` / ``persistent_attrs`` 类属性
    声明。"""
    return _gw.register_entity(cls, name)


def 注册空间(cls: type, name: str | None = None):
    """注册 Space 子类 (等价 ``register_space``; reference:
    goworld.RegisterSpace).  在 ``on_space_init`` 中调用
    ``enable_aoi(distance)`` 打开视野管理。"""
    return _gw.register_space(cls, name)


def 注册服务(cls: type, name: str | None = None):
    """注册集群单例服务 (等价 ``register_service``; reference:
    goworld.RegisterService, service.go:37-231).  每种服务类型全集群只
    实例化一个, 落点由 srvdis 协商; 提供方 game 宕机后自动故障转移。"""
    return _gw.register_service(cls, name)


def 本地创建空间(cls_name: str, kind: int = 1):
    """在当前 game 创建 Space (等价 ``create_space_locally``; reference:
    goworld.CreateSpaceLocally).  Space 终生驻留创建它的 game。"""
    return _gw.create_space_locally(cls_name, kind)


def 任意创建空间(cls_name: str, kind: int = 1) -> str:
    """在负载最低的 game 创建 Space, 返回其实体 id (等价
    ``create_space_anywhere``; reference: goworld.CreateSpaceAnywhere,
    负载均衡挑选见 DispatcherService.go:529-542)。"""
    return _gw.create_space_anywhere(cls_name, kind)


def 本地创建实体(type_name: str, **kwargs) -> Entity:
    """在当前 game 创建实体并返回对象 (等价 ``create_entity_locally``;
    reference: goworld.CreateEntityLocally)。"""
    return _gw.create_entity_locally(type_name, **kwargs)


def 任意创建实体(type_name: str, attrs: dict | None = None) -> str:
    """在负载最低的 game 创建实体, 返回其 id (等价
    ``create_entity_anywhere``; reference: goworld.CreateEntityAnywhere).
    创建期间发往该实体的调用由 dispatcher 排队, 创建完成后按序送达。"""
    return _gw.create_entity_anywhere(type_name, attrs)


def 任意加载实体(type_name: str, eid: str):
    """从存储加载持久化实体到某个 game (等价 ``load_entity_anywhere``;
    reference: goworld.LoadEntityAnywhere).  加载期间的调用同样被
    dispatcher 排队, 不会丢失 (DispatcherService.go:682-711 语义)。"""
    return _gw.load_entity_anywhere(type_name, eid)


def 调用(eid: str, method: str, *args):
    """按实体 id 调用其方法 (等价 ``call``; reference: goworld.Call,
    EntityManager.go:429-442).  目标在本 game 时走本地快速路径, 否则经
    该实体的 dispatcher 分片路由; 同一实体的调用保持先后顺序。"""
    return _gw.call(eid, method, *args)


def 调用服务(type_name: str, method: str, *args) -> bool:
    """调用集群单例服务 (等价 ``call_service``; reference:
    goworld.CallService).  服务尚未就绪时返回 False, 调用方应重试。"""
    return _gw.call_service(type_name, method, *args)


def 调用所有NilSpace(method: str, *args):
    """广播调用每个 game 的 nil space (等价 ``call_nil_spaces``;
    reference: goworld.CallNilSpaces) — 常用于全集群初始化逻辑。"""
    return _gw.call_nil_spaces(method, *args)


def 获取实体(eid: str) -> Entity | None:
    """取本 game 内的实体对象, 不存在返回 None (等价 ``get_entity``;
    reference: goworld.GetEntity)。"""
    return _gw.get_entity(eid)


def 获取GameID() -> int:
    """当前 game 进程编号 (等价 ``get_game_id``; reference:
    goworld.GetGameID)。"""
    return _gw.get_game_id()


def 投递(fn: Callable[[], None]):
    """把回调投递到逻辑线程, 在本 tick 末尾执行 (等价 ``post``;
    reference: post.Post, post.go:21-44) — 其它线程进入逻辑线程的唯一
    安全入口。"""
    return _gw.post(fn)


def KV读(key: str, callback):
    """异步读全局 KV 存储 (等价 ``kvdb_get``; reference:
    goworld.GetKVDB).  ``callback(value | None)`` 在逻辑线程执行;
    同一进程的 KV 操作串行, 先写后读可见。"""
    return _gw.kvdb_get(key, callback)


def KV写(key: str, val: str, callback=None):
    """异步写全局 KV 存储 (等价 ``kvdb_put``; reference:
    goworld.PutKVDB)。"""
    return _gw.kvdb_put(key, val, callback)


def KV取或写(key: str, val: str, callback=None):
    """原子地 "读旧值, 不存在则写入" (等价 ``kvdb_get_or_put``;
    reference: goworld.GetOrPutKVDB) — 注册类流程 (如账号占名) 的原语。
    ``callback(old | None)``: None 表示本次写入成功。"""
    return _gw.kvdb_get_or_put(key, val, callback)


def 注册定时任务(minute: int, hour: int, day: int, month: int,
                 dayofweek: int, cb: Callable[[], None]) -> int:
    """注册 crontab 定时回调, 分钟精度 (等价 ``register_crontab``;
    reference: goworld.RegisterCrontab, crontab.go:95-185).  负数表示
    "每 N" (如 minute=-5 为每 5 分钟); 返回句柄供注销。回调在逻辑线程
    执行。"""
    return _gw.register_crontab(minute, hour, day, month, dayofweek, cb)


def 注销定时任务(handle: int) -> bool:
    """注销 crontab 回调 (等价 ``unregister_crontab``)。"""
    return _gw.unregister_crontab(handle)


def 实体是否存在(type_name: str, eid: str, callback):
    """异步查询存储中是否存在该持久化实体 (等价 ``exists_entity``;
    reference: goworld.Exists)。"""
    return _gw.exists_entity(type_name, eid, callback)


def 列出实体ID(type_name: str, callback):
    """异步列出存储中该类型的全部实体 id (等价 ``list_entity_ids``;
    reference: goworld.ListEntityIDs)。"""
    return _gw.list_entity_ids(type_name, callback)
