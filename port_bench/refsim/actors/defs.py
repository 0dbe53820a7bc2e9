"""Actor class registry: enums, flags and the signal (I/O) vocabulary.

Copied from c_game_engine_tpu/actors/defs.py: the enums, flags, lane
counts and the compiler's name tables (class, input and output names, the
inputs each class handles). That module's docstring
lists the per-class fdata/idata and sfparams/siparams layouts. The port
never imports the JAX package, so the values live here too, and
tests/test_torch_kernels.py holds them equal (tests/test_torch_map_codecs.py
the name tables).
"""

from __future__ import annotations

import enum


class ParamType(enum.IntEnum):
    # an actor param's type tag (engine/include/engine/structs/KVList.h:41-53)
    BYTE = 0
    INTEGER = 1
    FLOAT = 2
    BOOL = 3
    STRING = 4
    NONE = 5
    COLOR = 6
    KV_LIST = 7
    ARRAY = 8
    UINT_64 = 9
    VEC2 = 10
    VEC3 = 11


# ---------------------------------------------------------------------------
# classes
# ---------------------------------------------------------------------------


class ActorClass(enum.IntEnum):
    # engine classes (engine/src/structs/ActorDefinition.c:79-96)
    IO_PROXY = 0
    LOGIC_BINARY = 1
    LOGIC_COUNTER = 2
    LOGIC_DECIMAL = 3
    SOUND_PLAYER = 4
    SPRITE = 5
    STATIC_MODEL = 6
    PHYSICS_MODEL = 7
    TRIGGER = 8
    GLOBAL_LIGHT = 9
    GLOBAL_FOG = 10
    TONEMAP_CONTROLLER = 11
    CAMERA = 12
    BUTTON = 13
    # game classes (game/src/helpers/GameActorRegistration.c:16-27)
    COIN = 14
    DOOR = 15
    GOAL = 16
    LASER = 17
    LASER_EMITTER = 18
    PHYSBOX = 19
    TEST_ACTOR = 20
    NPC_JOHN = 21
    ITEM_ERASER = 22


CLASS_NAMES: dict[str, ActorClass] = {
    "io_proxy": ActorClass.IO_PROXY,
    "logic_binary": ActorClass.LOGIC_BINARY,
    "logic_counter": ActorClass.LOGIC_COUNTER,
    "logic_decimal": ActorClass.LOGIC_DECIMAL,
    "sound_player": ActorClass.SOUND_PLAYER,
    "prop_sprite": ActorClass.SPRITE,
    "prop_model_static": ActorClass.STATIC_MODEL,
    "prop_model_physics": ActorClass.PHYSICS_MODEL,
    "trigger": ActorClass.TRIGGER,
    "global_light": ActorClass.GLOBAL_LIGHT,
    "global_fog": ActorClass.GLOBAL_FOG,
    "tonemap_controller": ActorClass.TONEMAP_CONTROLLER,
    "camera": ActorClass.CAMERA,
    "prop_button": ActorClass.BUTTON,
    "prop_coin": ActorClass.COIN,
    "prop_door": ActorClass.DOOR,
    "prop_goal": ActorClass.GOAL,
    "prop_laser": ActorClass.LASER,
    "prop_laser_emitter": ActorClass.LASER_EMITTER,
    "prop_physbox": ActorClass.PHYSBOX,
    "test_actor": ActorClass.TEST_ACTOR,
    "npc_john": ActorClass.NPC_JOHN,
    "item_eraser": ActorClass.ITEM_ERASER,
}

# Classes consumed by the map compiler rather than instantiated at runtime:
# "player" becomes the spawn transform (MapLoader.c:126-133); "light_point"
# is baked into the lightmap by the (external) editor compiler — ours too.
COMPILE_TIME_CLASSES = {"player", "light_point"}


# ---------------------------------------------------------------------------
# flags (reference: engine/include/engine/structs/Actor.h:31-36)
# ---------------------------------------------------------------------------


class ActorFlags(enum.IntFlag):
    CAN_PUSH_PLAYER = 1 << 0
    ENEMY = 1 << 1
    CAN_BLOCK_LASERS = 1 << 2
    CAN_BE_HELD = 1 << 3
    USING_BOUNDING_BOX_COLLISION = 1 << 4
    INTERACTABLE = 1 << 5


# ---------------------------------------------------------------------------
# signal vocabulary
# ---------------------------------------------------------------------------


class Input(enum.IntEnum):
    KILL = 0  # every class (ActorDefinition.c:73-77); unregistered on io_proxy
    OPEN = 1
    CLOSE = 2
    TURN_ON = 3
    TURN_OFF = 4
    SET = 5
    SET_INSTANT = 6
    ENABLE = 7
    DISABLE = 8
    FORCE_TRIGGER = 9
    OPERAND_A = 10
    OPERAND_B = 11
    EXECUTE = 12
    ADD = 13
    SUBTRACT = 14
    INCREMENT = 15
    DECREMENT = 16
    SET_COLOR = 17
    SET_SKIN = 18
    PLAY = 19
    PAUSE = 20
    RESUME = 21
    STOP = 22


class Output(enum.IntEnum):
    SPAWNED = 0  # every class (Actor.c:49)
    KILLED = 1
    FULLY_CLOSED = 2
    OPENING = 3
    FULLY_OPENED = 4
    CLOSING = 5
    PRESSED = 6
    UNPRESSED = 7
    COLLECTED = 8  # coin + goal share the name "collected"
    ENTERED = 9
    EXITED = 10
    TRIGGERED = 11
    ON_TRUE = 12
    ON_FALSE = 13
    EXECUTION_RESULT = 14
    COUNTER_CHANGED = 15
    HIT_MAX = 16
    LEFT_MAX = 17
    HIT_MIN = 18
    LEFT_MIN = 19
    FIRST_TICK = 20


INPUT_NAMES = {
    "kill": Input.KILL,
    "open": Input.OPEN,
    "close": Input.CLOSE,
    "turn_on": Input.TURN_ON,
    "turn_off": Input.TURN_OFF,
    "set": Input.SET,
    "set_instant": Input.SET_INSTANT,
    "enable": Input.ENABLE,
    "disable": Input.DISABLE,
    "force_trigger": Input.FORCE_TRIGGER,
    "operand_a": Input.OPERAND_A,
    "operand_b": Input.OPERAND_B,
    "execute": Input.EXECUTE,
    "add": Input.ADD,
    "subtract": Input.SUBTRACT,
    "increment": Input.INCREMENT,
    "decrement": Input.DECREMENT,
    "set_color": Input.SET_COLOR,
    "set_skin": Input.SET_SKIN,
    "play": Input.PLAY,
    "pause": Input.PAUSE,
    "resume": Input.RESUME,
    "stop": Input.STOP,
}

OUTPUT_NAMES = {
    "spawned": Output.SPAWNED,
    "killed": Output.KILLED,
    "fully_closed": Output.FULLY_CLOSED,
    "opening": Output.OPENING,
    "fully_opened": Output.FULLY_OPENED,
    "closing": Output.CLOSING,
    "pressed": Output.PRESSED,
    "unpressed": Output.UNPRESSED,
    "collected": Output.COLLECTED,
    "entered": Output.ENTERED,
    "exited": Output.EXITED,
    "triggered": Output.TRIGGERED,
    "on_true": Output.ON_TRUE,
    "on_false": Output.ON_FALSE,
    "execution_result": Output.EXECUTION_RESULT,
    "counter_changed": Output.COUNTER_CHANGED,
    "hit_max": Output.HIT_MAX,
    "left_max": Output.LEFT_MAX,
    "hit_min": Output.HIT_MIN,
    "left_min": Output.LEFT_MIN,
    "first_tick": Output.FIRST_TICK,
}

# Which inputs each class handles (others are dropped with a warning in the
# reference, ActorTriggerInput Actor.c:52-64; here: dropped at compile time).
CLASS_INPUTS: dict[ActorClass, set[Input]] = {
    ActorClass.IO_PROXY: set(),  # kill explicitly unregistered (IoProxy.c:Register)
    ActorClass.LOGIC_BINARY: {Input.KILL, Input.OPERAND_A, Input.OPERAND_B, Input.EXECUTE},
    ActorClass.LOGIC_COUNTER: {Input.KILL, Input.ADD, Input.SUBTRACT, Input.INCREMENT, Input.DECREMENT},
    ActorClass.LOGIC_DECIMAL: {Input.KILL, Input.OPERAND_A, Input.OPERAND_B, Input.EXECUTE},
    ActorClass.SOUND_PLAYER: {Input.KILL, Input.PLAY, Input.PAUSE, Input.RESUME, Input.STOP},
    ActorClass.SPRITE: {Input.KILL},
    ActorClass.STATIC_MODEL: {Input.KILL},
    ActorClass.PHYSICS_MODEL: {Input.KILL, Input.SET_COLOR, Input.SET_SKIN},
    ActorClass.TRIGGER: {Input.KILL, Input.FORCE_TRIGGER, Input.ENABLE, Input.DISABLE},
    ActorClass.GLOBAL_LIGHT: {Input.KILL, Input.SET, Input.SET_INSTANT},
    ActorClass.GLOBAL_FOG: {Input.KILL, Input.SET, Input.SET_INSTANT},
    ActorClass.TONEMAP_CONTROLLER: {Input.KILL, Input.SET, Input.SET_INSTANT},
    ActorClass.CAMERA: {Input.KILL, Input.ENABLE, Input.DISABLE},
    ActorClass.BUTTON: {Input.KILL},
    ActorClass.COIN: {Input.KILL},
    ActorClass.DOOR: {Input.KILL, Input.OPEN, Input.CLOSE},
    ActorClass.GOAL: {Input.KILL, Input.ENABLE, Input.DISABLE},
    ActorClass.LASER: {Input.KILL, Input.TURN_ON, Input.TURN_OFF},
    ActorClass.LASER_EMITTER: {Input.KILL, Input.TURN_ON, Input.TURN_OFF},
    ActorClass.PHYSBOX: {Input.KILL},
    ActorClass.TEST_ACTOR: {Input.KILL},
    ActorClass.NPC_JOHN: {Input.KILL},
    ActorClass.ITEM_ERASER: {Input.KILL},
}


# ---------------------------------------------------------------------------
# physics classification
# ---------------------------------------------------------------------------


class Motion(enum.IntEnum):
    NONE = 0  # empty shape, no collision (ActorCreateEmptyBody)
    STATIC = 1
    KINEMATIC = 2
    DYNAMIC = 3


class Shape(enum.IntEnum):
    EMPTY = 0
    BOX = 1  # half extents in shape_halfext
    WALL = 2  # two-sided quad hull from ActorWall (ActorWall.c:20-49)
    CYLINDER = 3  # halfext = (radius, half height, radius)


class Layer(enum.IntEnum):
    # reference: engine/include/engine/physics/Physics.h:36-43
    STATIC = 0
    DYNAMIC = 1
    PLAYER = 2
    SENSOR = 3


# door FSM states (game/src/actor/prop/Door.c:32-38)
class DoorState(enum.IntEnum):
    CLOSED = 0
    OPENING = 1
    OPEN = 2
    CLOSING = 3


class LaserHeight(enum.IntEnum):
    # game/include/actor/prop/Laser.h (heights used in Laser.c:196-209)
    FLOOR = 0
    MIDDLE = 1
    CEILING = 2
    TRIPLE = 3


class LogicOp(enum.IntEnum):
    AND = 0
    OR = 1
    NOT = 2


class DecimalOp(enum.IntEnum):
    EQUAL = 0
    GREATER_THAN = 1
    GREATER_THAN_OR_EQUAL = 2
    LESS_THAN = 3
    LESS_THAN_OR_EQUAL = 4


# sfparams / siparams lane counts
NUM_SFPARAMS = 8
NUM_SIPARAMS = 4
NUM_FDATA = 2
NUM_IDATA = 2
