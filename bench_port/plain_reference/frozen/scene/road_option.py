# Frozen copy of gail_carla_tpu_torch/scene/road_option.py at commit 97e926f, with
# its imports pointed at this copy: part of the benchmark's plain
# reference (bench_port/plain_reference/README.md). Never edited.
"""High-level navigation commands.

Value-compatible with the reference's ``RoadOption`` enum
(``carla_gym/core/task_actor/common/navigation/map_utils.py:5-17`` and the
copy in ``.../agents/utils/local_planner.py:8-19``): the integer values are
fed raw into the policy's command embedding (``tools/model.py:204-206``), so
they must match for demo/policy parity.
"""
import enum


class RoadOption(enum.IntEnum):
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6
