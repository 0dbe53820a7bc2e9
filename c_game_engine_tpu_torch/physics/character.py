"""Character controller constants (copied from
c_game_engine_tpu/physics/character.py:26-31; the reference is Jolt's
CharacterVirtual as configured in PlayerPhysics.c:173-194). The batched
controller itself is physics/batched.py::update_character_batched."""

CAPSULE_RADIUS = 0.2  # PlayerPhysics.c:176 (JPH_CapsuleShape_Create(0.2, 0.25))
CAPSULE_HALF_HEIGHT = 0.25
MAX_SLOPE_COS = 0.6427876097  # cos(50 deg), PlayerPhysics.c:42 MAX_WALKABLE_SLOPE
STEP_UP = 0.25  # walkStairsStepUp (PlayerPhysics.c:442)
STICK_DOWN = 0.25  # stickToFloorStepDown (PlayerPhysics.c:441)
CHARACTER_MASS = 10.0  # PlayerPhysics.c:184
